// The one-block CG solve of S lam = gamma and the primal step, shared by
// K4 (pcg_dz.cu), K5 (sqp_mega.cu, its dual-solve stage) and K6
// (bcr_pcg_dz.cu).
//
// One thread block holds S's three (N, 14, 14) bands and the CG vectors in
// shared memory; one thread per (knot, row) entry of an (N, 14) vector
// computes its 3x14-FMA band row, in strided loops when the block has
// fewer threads than entries.  The dot products reduce in a fixed order
// (warp shuffles, then warp 0) and every thread reads the one shared
// result, so all threads take the same exit decision.  The preconditioner
// is a template argument: the stair bands (K4, K5) or the block cyclic
// reduction solve (K6).
#pragma once
#include "lanedyn.cuh"

namespace pcgc {

constexpr int S = ld::NX, NU = ld::NU;

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

// Shared memory of one solve: S's three bands, `vecs` (N, 14) vectors and
// 33 reduction slots.
inline size_t cg_smem_floats(int N, int vecs) {
  return (size_t)3 * N * S * S + (size_t)vecs * N * S + 33;
}

// The stair preconditioner z = Pinv r from its bands (global memory);
// returns this thread's part of r . z.
struct StairPre {
  const float* PL;
  const float* PD;
  const float* PU;
  int N;
  LD_DEV float apply(const float* r, float* z) const {
    float part = 0.0f;
    for (int e = LD_TID; e < S * N; e += LD_NTID) {
      const float v = band_row(PL, PD, PU, r, N, e);
      z[e] = v;
      part += r[e] * v;
    }
    return part;
  }
};

// Copy S's bands into shared memory (SL, SD, SU, each N*S*S floats) and
// lam0 into lam; ends in a barrier.
LD_DEV void load_system(int N, const float* SLg, const float* SDg,
                        const float* SUg, const float* lam0, float* SL,
                        float* SD, float* SU, float* lam) {
  const int nb = S * S * N, n = S * N;
  for (int e = LD_TID; e < nb; e += LD_NTID) {
    SL[e] = SLg[e];
    SD[e] = SDg[e];
    SU[e] = SUg[e];
  }
  for (int e = LD_TID; e < n; e += LD_NTID) lam[e] = lam0[e];
  LD_SYNC();
}

// Warm-started preconditioned CG (MPCGPU alg. 2): exit when
// |eta| = |r' M^-1 r| <= tol or at max_iter.  lam holds lam0 on entry and
// the solution on exit; r, p, w are (N, 14) scratch vectors.  Returns the
// iteration count and the final eta.
template <class Pre>
LD_DEV int cg_solve(int N, const float* SL, const float* SD, const float* SU,
                    const float* gamma, float* lam, float* r, float* p,
                    float* w, float* red, const Pre& pre, int max_iter,
                    float tol, float* eta_out) {
  const int tid = LD_TID, nt = LD_NTID, n = S * N;
  // r = gamma - S lam
  for (int e = tid; e < n; e += nt) r[e] = gamma[e] - band_row(SL, SD, SU, lam, N, e);
  LD_SYNC();
  // p = M^-1 r, eta = r . p
  float eta = block_sum(pre.apply(r, p), red);

  int it = 0;
  while (it < max_iter && fabsf(eta) > tol) {
    // w = S p, alpha = eta / p.w
    float part = 0.0f;
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
    // w = M^-1 r, eta' = r . w
    const float eta_new = block_sum(pre.apply(r, w), red);
    const float beta = eta_new / eta;
    for (int e = tid; e < n; e += nt) p[e] = w[e] + beta * p[e];
    LD_SYNC();
    eta = eta_new;
    ++it;
  }
  *eta_out = eta;
  return it;
}

// Primal step recovery (dz.cuh:5-121) from lam (shared memory):
//   dx_k = -Qinv_k (q_k - lam_k + A_k' lam_{k+1})   (no A term at k = N-1)
//   du_k = -Rinv_k (r_k + B_k' lam_{k+1});
// also writes lam to lam_out.  rx, ru are (N, 14) shared scratch.
LD_DEV void dz_epilogue(int N, const float* lam, const float* A,
                        const float* B, const float* q, const float* r_in,
                        const float* Qinv, const float* Rinv, float* rx,
                        float* ru, float* lam_out, float* dX, float* dU) {
  const int tid = LD_TID, nt = LD_NTID, n = S * N;
  for (int e = tid; e < n; e += nt) {
    const int k = e / S, i = e % S;
    float acc = q[e] - lam[e];
    if (k < N - 1)
      for (int m = 0; m < S; ++m) acc += A[S * S * k + S * m + i] * lam[S * (k + 1) + m];
    rx[e] = acc;
    lam_out[e] = lam[e];
  }
  for (int e = tid; e < (N - 1) * NU; e += nt) {
    const int k = e / NU, i = e % NU;
    float acc = r_in[NU * k + i];
    for (int m = 0; m < S; ++m) acc += B[S * NU * k + NU * m + i] * lam[S * (k + 1) + m];
    ru[e] = acc;
  }
  LD_SYNC();
  for (int e = tid; e < n; e += nt) {
    const int k = e / S, i = e % S;
    float acc = 0.0f;
    for (int j = 0; j < S; ++j) acc += Qinv[S * S * k + S * i + j] * rx[S * k + j];
    dX[e] = -acc;
  }
  for (int e = tid; e < (N - 1) * NU; e += nt) {
    const int k = e / NU, i = e % NU;
    float acc = 0.0f;
    for (int j = 0; j < NU; ++j) acc += Rinv[NU * NU * k + NU * i + j] * ru[NU * k + j];
    dU[e] = -acc;
  }
}

// Largest horizon whose `floats_of(N)` shared floats, plus `static_bytes`,
// fit one block on this device; 0 if the attribute cannot be read.
template <class F>
inline int max_knots_for(F floats_of, size_t static_bytes) {
#ifdef __CUDACC__
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
#else
  const int bytes = 232448;
#endif
  int n = 0;
  while (floats_of(n + 1) * sizeof(float) + static_bytes <= (size_t)bytes) ++n;
  return n;
}

// K4's whole solve in one block: S into shared memory, stair-PCG from lam0,
// iteration count and hit flag, then dz.  smem holds cg_smem_floats(N, 4).
LD_DEV void pcg_dz_body(float* smem, int N, const float* SLg,
                        const float* SDg, const float* SUg, const float* PL,
                        const float* PD, const float* PU, const float* gamma,
                        const float* lam0, const float* A, const float* B,
                        const float* q, const float* r_in, const float* Qinv,
                        const float* Rinv, int max_iter, float tol,
                        float* lam_out, float* dX, float* dU, int* iters_out,
                        bool* hit_out) {
  const int nb = S * S * N, n = S * N;
  float* SL = smem;
  float* SD = SL + nb;
  float* SU = SD + nb;
  float* lam = SU + nb;
  float* r = lam + n;
  float* p = r + n;
  float* w = p + n;
  float* red = w + n;
  load_system(N, SLg, SDg, SUg, lam0, SL, SD, SU, lam);
  float eta;
  const int it = cg_solve(N, SL, SD, SU, gamma, lam, r, p, w, red,
                          StairPre{PL, PD, PU, N}, max_iter, tol, &eta);
  if (LD_TID == 0) {
    iters_out[0] = it;
    hit_out[0] = fabsf(eta) > tol;
  }
  dz_epilogue(N, lam, A, B, q, r_in, Qinv, Rinv, r, p, lam_out, dX, dU);
  LD_SYNC();
}

}  // namespace pcgc
