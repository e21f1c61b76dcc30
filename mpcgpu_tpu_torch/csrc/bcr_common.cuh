// The block cyclic reduction (BCR) of S lam = gamma, factored once and
// applied many times; shared by K6 (bcr_pcg_dz.cu, its CG's
// preconditioner), K7 and K7s (bcr_dz.cu: the refined solve + dz, and one
// unrefined solve) and K9b (sqp_mega.cu, the dual-solve stage of its
// per-iteration kernel).
//
// Design: factor once, apply many times.  The TPU kernels
// (mpcgpu_tpu/ops/pallas/bcr_kernel.py _bcr_lanes) redo the whole
// elimination of D, L, U -- log2(N) levels of 14x14 products and SPD
// inverses -- inside every solve, though none of it depends on the right-
// hand side.  Here one pass over the levels stores what the applies need:
//   per level l (h = 2^l) and kept knot i (i % 2h == 0):
//     LDm = L_i D_{i-h}^-1 and UDp = U_i D_{i+h}^-1;
//   per knot j, at the level where it is eliminated (and for the root):
//     Dinv_j, DL_j = Dinv_j L_j and DU_j = Dinv_j U_j,
// with kept knots updated in place (D -= LDm U_{i-h} + UDp L_{i+h},
// L = -LDm L_{i-h}, U = -UDp U_{i+h}).  An apply is then only the forward
// pass g_i -= LDm g_{i-h} + UDp g_{i+h} and the back substitution
// z_j = Dinv_j g_j - DL_j z_{j-h} - DU_j z_{j+h}: 2 log2(N) + 2 barriers.
// The factors take (6 + 2 log2 N) N 784 B in global memory (0.9 MB at
// N = 64), which stays in L2; the SPD inverses are lanedyn's warp
// Gauss-Jordan in shared memory, one warp per knot.  Everything runs in
// one thread block; S's bands may be in shared or global memory.
#pragma once
#include "pcg_common.cuh"

namespace bcr {

constexpr int S = ld::NX, SS = S * S;
// 512 threads at most: K6's registers (96 a thread without a bound) times
// 896 threads would pass the SM's 65,536
constexpr int MAX_THREADS = 512, MAX_WARPS = MAX_THREADS / 32;

LD_HD int levels_of(int N) {
  int l = 0;
  while ((1 << l) < N) ++l;
  return l;
}

// Floats of global scratch the factors of an N-knot solve take.
LD_HD size_t factor_floats(int N) {
  return (size_t)(6 + 2 * levels_of(N)) * N * SS;
}

// Threads of a one-block solve: one per (knot, row) entry, whole warps, at
// most MAX_THREADS.
inline int threads_for(int N) {
  const int t = ((S * N + 31) / 32) * 32;
  return t < MAX_THREADS ? t : MAX_THREADS;
}

// Largest power-of-2 horizon whose `floats_of(N)` shared floats fit one
// block on this device; 0 if the attribute cannot be read.
template <class F>
inline int pow2_max_knots(F floats_of) {
  const int n = pcgc::max_knots_for(floats_of, 0);
  int p = 0;
  while ((2 << p) <= n) ++p;
  return n > 0 ? 1 << p : 0;
}

// (A B)[i][j] for e = i*S + j, 14x14 row-major
LD_DEV float mm(const float* A, const float* B, int e) {
  const int i = e / S, j = e % S;
  float acc = 0.0f;
  for (int m = 0; m < S; ++m) acc += A[S * i + m] * B[S * m + j];
  return acc;
}

// row i of M (14x14) times x (14)
LD_DEV float mv_row(const float* M, const float* x, int i) {
  float acc = 0.0f;
  for (int m = 0; m < S; ++m) acc += M[S * i + m] * x[m];
  return acc;
}

struct BcrFactor {
  float* D;     // (N, S, S) working diagonal blocks
  float* L;     // (N, S, S) working lower blocks
  float* U;     // (N, S, S) working upper blocks
  float* Dinv;  // (N, S, S) at each knot's elimination level (root: knot 0)
  float* DL;    // (N, S, S) Dinv_j L_j
  float* DU;    // (N, S, S) Dinv_j U_j
  float* LDm;   // (levels, N, S, S), kept knots only
  float* UDp;   // (levels, N, S, S), kept knots only
  int N, levels;

  LD_DEV BcrFactor(float* base, int n, int lv) : N(n), levels(lv) {
    const size_t nb = (size_t)n * SS;
    D = base;
    L = D + nb;
    U = L + nb;
    Dinv = U + nb;
    DL = Dinv + nb;
    DU = DL + nb;
    LDm = DU + nb;
    UDp = LDm + (size_t)lv * nb;
  }
};

// Dinv[j] = D[j]^-1 for j = first, first + step, ... < N; one warp per knot.
LD_DEV void warp_inverses(const BcrFactor& f, int first, int step,
                          float* scratch) {
#ifdef __CUDACC__
  const int w = (int)threadIdx.x >> 5, nw = ((int)blockDim.x + 31) >> 5;
#else
  const int w = 0, nw = 1;
#endif
  float* A = scratch + SS * w;
  for (int j = first + w * step; j < f.N; j += nw * step) {
    for (int e = ld::lane(); e < SS; e += ld::lanes()) A[e] = f.D[SS * j + e];
    ld::warp_sync();
    ld::warp_spd_inverse<S>(A);
    for (int e = ld::lane(); e < SS; e += ld::lanes()) f.Dinv[SS * j + e] = A[e];
    ld::warp_sync();
  }
}

// The elimination, once per solve, from S's bands.  inv_scratch: one
// 14x14 block of shared memory per warp.
LD_DEV void bcr_factor(const BcrFactor& f, const float* SL, const float* SD,
                       const float* SU, float* inv_scratch) {
  const int tid = LD_TID, nt = LD_NTID, n = f.N;
  for (int e = tid; e < n * SS; e += nt) {
    f.D[e] = SD[e];
    f.L[e] = SL[e];
    f.U[e] = SU[e];
  }
  LD_SYNC();
  for (int l = 0; l < f.levels; ++l) {
    const int h = 1 << l, nk = n / (2 * h);
    float* LDm = f.LDm + (size_t)l * n * SS;
    float* UDp = f.UDp + (size_t)l * n * SS;
    warp_inverses(f, h, 2 * h, inv_scratch);   // knots eliminated at l
    LD_SYNC();
    for (int e = tid; e < nk * SS; e += nt) {
      const int i = (e / SS) * 2 * h, j = i + h, ee = e % SS;
      LDm[SS * i + ee] = i >= h ? mm(f.L + SS * i, f.Dinv + SS * (i - h), ee) : 0.0f;
      UDp[SS * i + ee] = mm(f.U + SS * i, f.Dinv + SS * j, ee);
      f.DL[SS * j + ee] = mm(f.Dinv + SS * j, f.L + SS * j, ee);
      f.DU[SS * j + ee] = j + h <= n - 1 ? mm(f.Dinv + SS * j, f.U + SS * j, ee) : 0.0f;
    }
    LD_SYNC();
    // kept knots: read only their eliminated neighbours, write themselves
    for (int e = tid; e < nk * SS; e += nt) {
      const int i = (e / SS) * 2 * h, ee = e % SS;
      float d = f.D[SS * i + ee] - mm(UDp + SS * i, f.L + SS * (i + h), ee);
      float lo = 0.0f;
      if (i >= h) {
        d -= mm(LDm + SS * i, f.U + SS * (i - h), ee);
        lo = -mm(LDm + SS * i, f.L + SS * (i - h), ee);
      }
      const float up = -mm(UDp + SS * i, f.U + SS * (i + h), ee);
      f.D[SS * i + ee] = d;
      f.L[SS * i + ee] = lo;
      f.U[SS * i + ee] = up;
    }
    LD_SYNC();
  }
  warp_inverses(f, 0, n, inv_scratch);         // the root
  LD_SYNC();
}

// z = BCR(r) from the stored factors; returns this thread's part of r . z.
// g is an (N, S) shared scratch vector; ends in a barrier (z complete).
struct BcrPre {
  BcrFactor f;
  float* g;
  LD_DEV float apply(const float* r, float* z) const {
    const int tid = LD_TID, nt = LD_NTID, n = f.N;
    for (int e = tid; e < n * S; e += nt) g[e] = r[e];
    LD_SYNC();
    for (int l = 0; l < f.levels; ++l) {
      const int h = 1 << l, nk = n / (2 * h);
      const float* LDm = f.LDm + (size_t)l * n * SS;
      const float* UDp = f.UDp + (size_t)l * n * SS;
      for (int e = tid; e < nk * S; e += nt) {
        const int i = (e / S) * 2 * h, row = e % S;
        float acc = g[S * i + row] - mv_row(UDp + SS * i, g + S * (i + h), row);
        if (i >= h) acc -= mv_row(LDm + SS * i, g + S * (i - h), row);
        g[S * i + row] = acc;
      }
      LD_SYNC();
    }
    for (int e = tid; e < S; e += nt) z[e] = mv_row(f.Dinv, g, e);
    LD_SYNC();
    for (int l = f.levels - 1; l >= 0; --l) {
      const int h = 1 << l, nk = n / (2 * h);
      for (int e = tid; e < nk * S; e += nt) {
        const int j = (e / S) * 2 * h + h, row = e % S;
        float acc = mv_row(f.Dinv + SS * j, g + S * j, row)
                    - mv_row(f.DL + SS * j, z + S * (j - h), row);
        if (j + h <= n - 1) acc -= mv_row(f.DU + SS * j, z + S * (j + h), row);
        z[S * j + row] = acc;
      }
      LD_SYNC();
    }
    float part = 0.0f;
    for (int e = tid; e < n * S; e += nt) part += r[e] * z[e];
    return part;
  }
};

// Shared floats of bcr_dz_body: lam, r, w, g (each (N, S)) and one 14x14
// inverse scratch per warp.
LD_HD size_t dz_vec_floats(int N) {
  return (size_t)4 * N * S + (size_t)MAX_WARPS * SS;
}

// The TPU's _bcr_refined and its dz (bcr_kernel.py:107-120, 164-183):
// factor S into fac (factor_floats(N) of global scratch), lam = BCR(gamma),
// r = gamma - S lam, lam += BCR(r), then K4's dz epilogue; lam to lam_out.
// vecs: dz_vec_floats(N) shared floats.  Ends in a barrier.
LD_DEV void bcr_dz_body(int N, const float* SL, const float* SD,
                        const float* SU, const float* gamma, const float* A,
                        const float* B, const float* q, const float* r_in,
                        const float* Qinv, const float* Rinv, float* fac,
                        float* vecs, float* lam_out, float* dX, float* dU) {
  const int n = S * N;
  float* lam = vecs;
  float* r = lam + n;
  float* w = r + n;
  float* g = w + n;
  float* inv = g + n;
  const BcrFactor f(fac, N, levels_of(N));
  bcr_factor(f, SL, SD, SU, inv);
  const BcrPre pre{f, g};
  pre.apply(gamma, lam);
  for (int e = LD_TID; e < n; e += LD_NTID)
    r[e] = gamma[e] - pcgc::band_row(SL, SD, SU, lam, N, e);
  LD_SYNC();
  pre.apply(r, w);
  for (int e = LD_TID; e < n; e += LD_NTID) lam[e] += w[e];
  LD_SYNC();
  pcgc::dz_epilogue(N, lam, A, B, q, r_in, Qinv, Rinv, r, w, lam_out, dX, dU);
  LD_SYNC();
}

}  // namespace bcr
