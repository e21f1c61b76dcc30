// The one-block CG solve of S lam = gamma and the primal step, shared by
// K4 and K4b (pcg_dz.cu), K5 (sqp_mega.cu, its dual-solve stage), K6
// (bcr_pcg_dz.cu) and K10 (sqp_mega_packed.cu, which drives cg_init and
// cg_step itself: its arms' CGs share one exit); and the grid-wide form of
// the stair-PCG and the primal step (grid_cg_solve, grid_dz) for K4g, K4bg
// (pcg_dz.cu), K5g and K9pg (sqp_mega.cu), past the one-block fit.
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
// 33 reduction slots; cg_area lays them out (lam, r, p, w for vecs = 4).
LD_HD size_t cg_smem_floats(int N, int vecs) {
  return (size_t)3 * N * S * S + (size_t)vecs * N * S + 33;
}

struct CgArea {
  float *SL, *SD, *SU, *lam, *r, *p, *w, *red;
};

LD_DEV CgArea cg_area(float* smem, int N) {
  const int nb = S * S * N, n = S * N;
  CgArea a;
  a.SL = smem;
  a.SD = a.SL + nb;
  a.SU = a.SD + nb;
  a.lam = a.SU + nb;
  a.r = a.lam + n;
  a.p = a.r + n;
  a.w = a.p + n;
  a.red = a.w + n;
  return a;
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

// num / den, or 0 where num is 0 when `safe` (the packed CG's 0/0 -> 0:
// an arm whose residual is exactly zero freezes instead of making NaN).
LD_DEV float cg_div(float num, float den, bool safe) {
  return (safe && !(fabsf(num) > 0.0f)) ? 0.0f : num / den;
}

// The CG's start from lam (warm, (N, 14)): r = gamma - S lam, p = M^-1 r;
// returns eta = r . p.
template <class Pre>
LD_DEV float cg_init(int N, const float* SL, const float* SD, const float* SU,
                     const float* gamma, const float* lam, float* r, float* p,
                     float* red, const Pre& pre) {
  const int tid = LD_TID, nt = LD_NTID, n = S * N;
  for (int e = tid; e < n; e += nt) r[e] = gamma[e] - band_row(SL, SD, SU, lam, N, e);
  LD_SYNC();
  return block_sum(pre.apply(r, p), red);
}

// One CG iteration from eta = r . p; returns the new eta.  w is (N, 14)
// scratch; `safe` selects cg_div's 0/0 -> 0 for alpha and beta.
template <class Pre>
LD_DEV float cg_step(int N, const float* SL, const float* SD, const float* SU,
                     float* lam, float* r, float* p, float* w, float* red,
                     const Pre& pre, float eta, bool safe) {
  const int tid = LD_TID, nt = LD_NTID, n = S * N;
  // w = S p, alpha = eta / p.w
  float part = 0.0f;
  for (int e = tid; e < n; e += nt) {
    const float z = band_row(SL, SD, SU, p, N, e);
    w[e] = z;
    part += p[e] * z;
  }
  const float alpha = cg_div(eta, block_sum(part, red), safe);
  for (int e = tid; e < n; e += nt) {
    lam[e] += alpha * p[e];
    r[e] -= alpha * w[e];
  }
  LD_SYNC();
  // w = M^-1 r, eta' = r . w
  const float eta_new = block_sum(pre.apply(r, w), red);
  const float beta = cg_div(eta_new, eta, safe);
  for (int e = tid; e < n; e += nt) p[e] = w[e] + beta * p[e];
  LD_SYNC();
  return eta_new;
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
  float eta = cg_init(N, SL, SD, SU, gamma, lam, r, p, red, pre);
  int it = 0;
  while (it < max_iter && fabsf(eta) > tol) {
    eta = cg_step(N, SL, SD, SU, lam, r, p, w, red, pre, eta, false);
    ++it;
  }
  *eta_out = eta;
  return it;
}

// Primal step recovery (dz.cuh:5-121) from lam (shared memory):
//   dx_k = -Qinv_k (q_k - lam_k + A_k' lam_{k+1})   (no A term at k = N-1)
//   du_k = -Rinv_k (r_k + B_k' lam_{k+1});
// also writes lam to lam_out unless it is null.  rx, ru are (N, 14) shared
// scratch.
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
    if (lam_out) lam_out[e] = lam[e];
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

// K4b's solve in one block: S into shared memory, stair-PCG from lam0, the
// iteration count and hit flag.  smem holds cg_smem_floats(N, 4); returns
// its layout, with the solution in lam (the block synchronised).
LD_DEV CgArea pcg_solve_body(float* smem, int N, const float* SLg,
                             const float* SDg, const float* SUg,
                             const float* PL, const float* PD,
                             const float* PU, const float* gamma,
                             const float* lam0, int max_iter, float tol,
                             int* iters_out, bool* hit_out) {
  const CgArea a = cg_area(smem, N);
  load_system(N, SLg, SDg, SUg, lam0, a.SL, a.SD, a.SU, a.lam);
  float eta;
  const int it = cg_solve(N, a.SL, a.SD, a.SU, gamma, a.lam, a.r, a.p, a.w,
                          a.red, StairPre{PL, PD, PU, N}, max_iter, tol, &eta);
  if (LD_TID == 0) {
    iters_out[0] = it;
    hit_out[0] = fabsf(eta) > tol;
  }
  return a;
}

// K4's whole solve in one block: K4b's solve, then dz.  smem holds
// cg_smem_floats(N, 4).
LD_DEV void pcg_dz_body(float* smem, int N, const float* SLg,
                        const float* SDg, const float* SUg, const float* PL,
                        const float* PD, const float* PU, const float* gamma,
                        const float* lam0, const float* A, const float* B,
                        const float* q, const float* r_in, const float* Qinv,
                        const float* Rinv, int max_iter, float tol,
                        float* lam_out, float* dX, float* dU, int* iters_out,
                        bool* hit_out) {
  const CgArea a = pcg_solve_body(smem, N, SLg, SDg, SUg, PL, PD, PU, gamma,
                                  lam0, max_iter, tol, iters_out, hit_out);
  dz_epilogue(N, a.lam, A, B, q, r_in, Qinv, Rinv, a.r, a.p, lam_out, dX, dU);
  LD_SYNC();
}

// ---------------------------------------------------------------------------
// The grid-wide stair-PCG (the original GBD-PCG's form, pcg/sqp.cuh:137-166):
// one cooperative launch, every block in the solve, S, the stair bands,
// gamma and the CG vectors in global memory (2.4 MB of bands at N = 512,
// L2-resident), nothing N-sized in shared memory.  Block b owns knots
// b, b + gridDim, ...; thread i < 14 of a block computes row i of the
// owned knot's entries.  The owner of knot k is the block that wrote rows k
// of the bands and gamma in the stages before (K5g), so bands are read by
// their writer; vectors at k - 1 and k + 1 come from other blocks and are
// read past L1 (load_cg), as are the dot slots.
//
// Each dot product: the owner of knot k sums its 14 products in a fixed
// order into slot k; after a grid barrier every block sums the N slots in
// the same fixed order (thread t takes k = t, t + blockDim, ..., then
// block_sum), so every block holds the same bits and takes the same exit
// decision -- a block leaving the loop early would hang the next barrier.
// No atomics: their order would change from run to run.  The sums do not
// depend on the grid size.  One slot array serves each kind of dot: every
// read of a slot is followed by a grid barrier before its next write.
//
// Grid barriers ("|"), in the simplest right order, four per iteration:
//   r = gamma - S lam0 | z = P r, p = z, eta slots | eta; then per step
//   w = S p, p.w slots | alpha; lam += alpha p, r -= alpha w |
//   z = P r, eta slots | eta', beta; p = z + beta p |
// (S p and P r read p and r at k +- 1; each slot sum follows its writes).
// The first barrier is also the one between the last read of lam0 and the
// first write of lam, which lets lam0 and lam alias (K5g's warm start in
// place); every exit follows a barrier after the last write of lam, which
// grid_dz's read of lam_{k+1} needs.

// The CG's global vectors (N, 14) each and its 2N dot slots (eta, p.w).
struct GridCg {
  float *r, *p, *w, *z, *slots;
};

LD_HD size_t grid_cg_floats(int N) { return (size_t)4 * N * S + (size_t)2 * N; }

LD_DEV GridCg grid_cg_area(float* g, int N) {
  const size_t n = (size_t)S * N;
  return GridCg{g, g + n, g + 2 * n, g + 3 * n, g + 4 * n};
}

// A float another block wrote in this launch, read past L1 (ld.global.cg).
LD_DEV float load_cg(const float* p) {
#ifdef __CUDACC__
  return __ldcg(p);
#else
  return *p;
#endif
}

// Row i of band-row k of (L, D, U) times x, x read past L1.
LD_DEV float band_row_cg(const float* L, const float* D, const float* U,
                         const float* x, int N, int k, int i) {
  const int o = S * S * k + S * i;
  float acc = 0.0f;
  for (int j = 0; j < S; ++j) acc += D[o + j] * load_cg(x + S * k + j);
  if (k > 0)
    for (int j = 0; j < S; ++j) acc += L[o + j] * load_cg(x + S * (k - 1) + j);
  if (k < N - 1)
    for (int j = 0; j < S; ++j) acc += U[o + j] * load_cg(x + S * (k + 1) + j);
  return acc;
}

// The sum of the N slots, the same in every block.
LD_DEV float slot_sum(const float* slots, int N, float* red) {
  float v = 0.0f;
  for (int k = LD_TID; k < N; k += LD_NTID) v += load_cg(slots + k);
  return block_sum(v, red);
}

// y = M x over the owned knots (M's bands L, D, U), and slot k = the dot of
// dot_x's and y's entries at knot k; copy, when not null, receives y too.
// Every thread of the block takes part (block_sum).
LD_DEV void grid_band_apply(int N, const float* L, const float* D,
                            const float* U, const float* x, float* y,
                            float* copy, const float* dot_x, float* slots,
                            float* red) {
  for (int k = LD_BID; k < N; k += LD_NBID) {
    float part = 0.0f;
    for (int i = LD_TID; i < S; i += LD_NTID) {
      const float v = band_row_cg(L, D, U, x, N, k, i);
      y[S * k + i] = v;
      if (copy) copy[S * k + i] = v;
      part += load_cg(dot_x + S * k + i) * v;
    }
    const float dot = block_sum(part, red);
    if (LD_TID == 0) slots[k] = dot;
  }
}

// The warm-started stair-PCG of S lam = gamma over the whole grid (every
// block calls it, with the same arguments): exit when |eta| <= tol or at
// max_iter.  lam0 and lam may alias; returns the iteration count and the
// final eta.
LD_DEV int grid_cg_solve(int N, const float* SL, const float* SD,
                         const float* SU, const float* PL, const float* PD,
                         const float* PU, const float* gamma,
                         const float* lam0, float* lam, GridCg g,
                         int max_iter, float tol, float* eta_out) {
  LD_SHARED float red[33];
  const int t = LD_TID, nt = LD_NTID, bid = LD_BID, nb = LD_NBID;
  float* const eta_slots = g.slots;
  float* const pw_slots = g.slots + N;

  // r = gamma - S lam0, and lam = lam0 unless they alias
  for (int k = bid; k < N; k += nb)
    for (int i = t; i < S; i += nt) {
      const int e = S * k + i;
      g.r[e] = gamma[e] - band_row_cg(SL, SD, SU, lam0, N, k, i);
      if (lam != lam0) lam[e] = lam0[e];
    }
  LD_GRID_SYNC();
  // z = P r, p = z, eta = r . z
  grid_band_apply(N, PL, PD, PU, g.r, g.z, g.p, g.r, eta_slots, red);
  LD_GRID_SYNC();
  float eta = slot_sum(eta_slots, N, red);
  int it = 0;
  while (it < max_iter && fabsf(eta) > tol) {
    // w = S p, alpha = eta / p . w
    grid_band_apply(N, SL, SD, SU, g.p, g.w, nullptr, g.p, pw_slots, red);
    LD_GRID_SYNC();
    const float alpha = eta / slot_sum(pw_slots, N, red);
    for (int k = bid; k < N; k += nb)
      for (int i = t; i < S; i += nt) {
        const int e = S * k + i;
        lam[e] += alpha * g.p[e];
        g.r[e] -= alpha * g.w[e];
      }
    LD_GRID_SYNC();
    // z = P r, eta' = r . z
    grid_band_apply(N, PL, PD, PU, g.r, g.z, nullptr, g.r, eta_slots, red);
    LD_GRID_SYNC();
    const float eta_new = slot_sum(eta_slots, N, red);
    const float beta = eta_new / eta;
    for (int k = bid; k < N; k += nb)
      for (int i = t; i < S; i += nt) {
        const int e = S * k + i;
        g.p[e] = g.z[e] + beta * g.p[e];
      }
    LD_GRID_SYNC();
    eta = eta_new;
    ++it;
  }
  *eta_out = eta;
  return it;
}

// The primal step (dz_epilogue's arithmetic in the same order) over the
// owned knots, lam in global memory after a grid barrier; also writes lam
// to lam_out unless it is null.
LD_DEV void grid_dz(int N, const float* lam, const float* A, const float* B,
                    const float* q, const float* r_in, const float* Qinv,
                    const float* Rinv, float* lam_out, float* dX, float* dU) {
  LD_SHARED float rx[S], ru[NU];
  const int t = LD_TID, nt = LD_NTID;
  for (int k = LD_BID; k < N; k += LD_NBID) {
    const bool has_u = k < N - 1;
    for (int i = t; i < S; i += nt) {
      const float lk = load_cg(lam + S * k + i);
      float acc = q[S * k + i] - lk;
      if (has_u)
        for (int m = 0; m < S; ++m)
          acc += A[S * S * k + S * m + i] * load_cg(lam + S * (k + 1) + m);
      rx[i] = acc;
      if (lam_out) lam_out[S * k + i] = lk;
    }
    if (has_u)
      for (int i = t; i < NU; i += nt) {
        float acc = r_in[NU * k + i];
        for (int m = 0; m < S; ++m)
          acc += B[S * NU * k + NU * m + i] * load_cg(lam + S * (k + 1) + m);
        ru[i] = acc;
      }
    LD_SYNC();
    for (int i = t; i < S; i += nt) {
      float acc = 0.0f;
      for (int j = 0; j < S; ++j) acc += Qinv[S * S * k + S * i + j] * rx[j];
      dX[S * k + i] = -acc;
    }
    if (has_u)
      for (int i = t; i < NU; i += nt) {
        float acc = 0.0f;
        for (int j = 0; j < NU; ++j) acc += Rinv[NU * NU * k + NU * i + j] * ru[j];
        dU[NU * k + i] = -acc;
      }
    LD_SYNC();
  }
}

}  // namespace pcgc
