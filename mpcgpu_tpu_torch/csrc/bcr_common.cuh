// The block cyclic reduction (BCR) of S lam = gamma, factored once and
// applied many times; shared by K7 and K7s (bcr_dz.cu: the refined solve +
// dz, and one unrefined solve) and K9b (sqp_mega.cu, the dual-solve stage
// of its per-iteration kernel) in one block, and by K6 (bcr_pcg_dz.cu, its
// CG's preconditioner) across one thread-block cluster (cluster_factor,
// ClusterBcr, below).
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
// Shared floats of the cluster factor's per-warp scratch (two 14x14 blocks)
constexpr int SCRATCH_FLOATS = 2 * MAX_WARPS * SS;

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

// ---------------------------------------------------------------------------
// The cluster form (K6): the same factor and apply spread over the C blocks
// of a thread-block cluster (pcg_common.cuh's ClusterCg: block r owns knots
// [r nk, r nk + own) and their S bands).  The factors stay in global memory
// (L2), laid out as above; another SM of the cluster may have written what
// a warp reads, and the cluster barrier between (release / acquire at
// cluster scope) makes those writes visible to ordinary loads.  At each
// level the eliminated knots' inverses, then each
// (kept i, eliminated i + h) pair's products and kept-knot update, are
// taken one warp per knot or pair by all C x (warps per block) warps, with
// a cluster barrier after each: 2 log2(N) + 2 barriers.  A pair's products
// and its kept knot's update read nothing another pair writes, so one warp
// does both with a warp barrier between.  Each entry is bcr_factor's
// expression on the same operands, so the factors equal the one-block
// factor's bit for bit.  The apply (ClusterBcr) keeps g and z in the
// owners' shared memory and reads the rows at i +- h through DSMEM:
// log2(N) forward levels, the root, log2(N) back levels, a cluster barrier
// after each but the last.

// Warp gw of nw: Dinv[j] = D[j]^-1 for j = first + step t, t = gw,
// gw + nw, ...; A is the warp's 14x14 shared scratch.
LD_DEV void spread_inverses(const BcrFactor& f, int first, int step, int gw,
                            int nw, float* A) {
  for (int j = first + gw * step; j < f.N; j += nw * step) {
    for (int e = ld::lane(); e < SS; e += ld::lanes()) A[e] = f.D[SS * j + e];
    ld::warp_sync();
    ld::warp_spd_inverse<S>(A);
    for (int e = ld::lane(); e < SS; e += ld::lanes()) f.Dinv[SS * j + e] = A[e];
    ld::warp_sync();
  }
}

// A lane's entries of a 14x14 block (ee = lane, lane + lanes, ...).
#ifdef __CUDACC__
constexpr int LANE_ENTRIES = (SS + 31) / 32;
#else
constexpr int LANE_ENTRIES = SS;
#endif

// Copy the 14x14 blocks x and y (global memory; null: keep what is there)
// into the warp's shared scratch sx and sy, coalesced, between warp
// barriers.
LD_DEV void stage(float* sx, const float* x, float* sy, const float* y) {
  ld::warp_sync();
  for (int e = ld::lane(); e < SS; e += ld::lanes()) {
    if (x) sx[e] = x[e];
    if (y) sy[e] = y[e];
  }
  ld::warp_sync();
}

// Warp gw of nw at level l: for pairs t = gw, gw + nw, ... (kept
// i = 2 h t, eliminated j = i + h) the products LDm_i, UDp_i, DL_j, DU_j,
// then the kept knot's D_i, L_i, U_i: bcr_factor's expressions, each
// product's operands staged in the warp's shared scratch sx, sy first
// (one coalesced copy from L2 in place of a load per multiply-add).
LD_DEV void spread_level(const BcrFactor& f, int l, int gw, int nw, float* sx,
                         float* sy) {
  const int h = 1 << l, n = f.N, nk = n / (2 * h), ln = ld::lane(),
            lns = ld::lanes();
  for (int t = gw; t < nk; t += nw) {
    const int i = 2 * h * t, j = i + h;
    float* LDm = f.LDm + (size_t)l * n * SS + SS * i;
    float* UDp = f.UDp + (size_t)l * n * SS + SS * i;
    if (i >= h) stage(sx, f.L + SS * i, sy, f.Dinv + SS * (i - h));
    for (int ee = ln; ee < SS; ee += lns) LDm[ee] = i >= h ? mm(sx, sy, ee) : 0.0f;
    stage(sx, f.U + SS * i, sy, f.Dinv + SS * j);
    for (int ee = ln; ee < SS; ee += lns) UDp[ee] = mm(sx, sy, ee);
    stage(sx, f.Dinv + SS * j, sy, f.L + SS * j);
    for (int ee = ln; ee < SS; ee += lns) f.DL[SS * j + ee] = mm(sx, sy, ee);
    const bool has_u = j + h <= n - 1;
    if (has_u) stage(nullptr, nullptr, sy, f.U + SS * j);
    for (int ee = ln; ee < SS; ee += lns)
      f.DU[SS * j + ee] = has_u ? mm(sx, sy, ee) : 0.0f;
    // the kept knot: D_i - UDp_i L_{i+h} - LDm_i U_{i-h},
    // L_i = -LDm_i L_{i-h}, U_i = -UDp_i U_{i+h}
    float d[LANE_ENTRIES], lo[LANE_ENTRIES], up[LANE_ENTRIES];
    stage(sx, UDp, sy, f.L + SS * j);
    for (int q = 0, ee = ln; ee < SS; ++q, ee += lns)
      d[q] = f.D[SS * i + ee] - mm(sx, sy, ee);
    stage(nullptr, nullptr, sy, f.U + SS * j);
    for (int q = 0, ee = ln; ee < SS; ++q, ee += lns) up[q] = -mm(sx, sy, ee);
    if (i >= h) {
      stage(sx, LDm, sy, f.U + SS * (i - h));
      for (int q = 0, ee = ln; ee < SS; ++q, ee += lns) d[q] -= mm(sx, sy, ee);
      stage(nullptr, nullptr, sy, f.L + SS * (i - h));
      for (int q = 0, ee = ln; ee < SS; ++q, ee += lns) lo[q] = -mm(sx, sy, ee);
    } else {
      for (int q = 0; q < LANE_ENTRIES; ++q) lo[q] = 0.0f;
    }
    for (int q = 0, ee = ln; ee < SS; ++q, ee += lns) {
      f.D[SS * i + ee] = d[q];
      f.L[SS * i + ee] = lo[q];
      f.U[SS * i + ee] = up[q];
    }
    ld::warp_sync();
  }
}

// The factor over the cluster from the own knots' S bands (a.SL, SD, SU);
// scratch: two 14x14 blocks of shared memory per warp (SCRATCH_FLOATS).
// Ends in a cluster barrier.
LD_DEV void cluster_factor(const BcrFactor& f, const pcgc::ClusterCg& a,
                           float* scratch) {
  const size_t o = (size_t)SS * a.k0;
  for (int e = LD_TID; e < SS * a.own; e += LD_NTID) {
    f.D[o + e] = a.SD[e];
    f.L[o + e] = a.SL[e];
    f.U[o + e] = a.SU[e];
  }
  LD_CLUSTER_SYNC();
#ifdef __CUDACC__
  const int warp = (int)threadIdx.x >> 5, warps = ((int)blockDim.x + 31) >> 5;
#else
  const int warp = 0, warps = 1;
#endif
  const int gw = a.rank * warps + warp, nw = a.C * warps;
  float* sx = scratch + 2 * SS * warp;
  float* sy = sx + SS;
  for (int l = 0; l < f.levels; ++l) {
    const int h = 1 << l;
    spread_inverses(f, h, 2 * h, gw, nw, sx);   // knots eliminated at l
    LD_CLUSTER_SYNC();
    spread_level(f, l, gw, nw, sx, sy);
    LD_CLUSTER_SYNC();
  }
  spread_inverses(f, 0, f.N, gw, nw, sx);      // the root
  LD_CLUSTER_SYNC();
}

// The own knots i = first, first + 2h, ... < k0 + own with i % 2h == off:
// the first of them and their count.
LD_DEV int own_knots(const pcgc::ClusterCg& a, int h, int off, int* first) {
  const int end = a.k0 + a.own, step = 2 * h;
  const int m = a.k0 > off ? (a.k0 - off + step - 1) / step : 0;
  *first = m * step + off;
  return *first < end ? (end - *first + step - 1) / step : 0;
}

// z = BCR(r) over the cluster from the stored factors (own rows of the
// (nk + 2, 14) vectors r and z; g is a.g), in the phases below with a
// cluster barrier after each but the last; returns this thread's part of
// r . z.  Every block calls it alike; ends in a block barrier.
struct ClusterBcr {
  BcrFactor f;

  // level l of the forward pass over the own kept knots (i % 2h == 0):
  // g_i -= UDp_i g_{i+h} + LDm_i g_{i-h}
  LD_DEV void forward(const pcgc::ClusterCg& a, int l) const {
    const int h = 1 << l, n = f.N;
    const float* LDm = f.LDm + (size_t)l * n * SS;
    const float* UDp = f.UDp + (size_t)l * n * SS;
    int first;
    const int cnt = own_knots(a, h, 0, &first);
    for (int e = LD_TID; e < cnt * S; e += LD_NTID) {
      const int i = first + (e / S) * 2 * h, row = e % S;
      float* gi = a.g + S * (i - a.k0 + 1);
      float acc = gi[row] - mv_row(UDp + SS * i, pcgc::knot_row(a, a.g, i + h), row);
      if (i >= h) acc -= mv_row(LDm + SS * i, pcgc::knot_row(a, a.g, i - h), row);
      gi[row] = acc;
    }
  }

  // the root: z_0 = Dinv_0 g_0 (in the block that owns knot 0)
  LD_DEV void root(const pcgc::ClusterCg& a, float* z) const {
    if (a.k0 == 0 && a.own > 0)
      for (int e = LD_TID; e < S; e += LD_NTID) z[S + e] = mv_row(f.Dinv, a.g + S, e);
  }

  // level l of the back substitution over the own knots eliminated at l
  // (j % 2h == h): z_j = Dinv_j g_j - DL_j z_{j-h} - DU_j z_{j+h}
  LD_DEV void back(const pcgc::ClusterCg& a, int l, float* z) const {
    const int h = 1 << l, n = f.N;
    int first;
    const int cnt = own_knots(a, h, h, &first);
    for (int e = LD_TID; e < cnt * S; e += LD_NTID) {
      const int j = first + (e / S) * 2 * h, row = e % S;
      float acc = mv_row(f.Dinv + SS * j, a.g + S * (j - a.k0 + 1), row)
                  - mv_row(f.DL + SS * j, pcgc::knot_row(a, z, j - h), row);
      if (j + h <= n - 1)
        acc -= mv_row(f.DU + SS * j, pcgc::knot_row(a, z, j + h), row);
      z[S * (j - a.k0 + 1) + row] = acc;
    }
  }

  LD_DEV float apply(const pcgc::ClusterCg& a, const float* r, float* z) const {
    for (int e = LD_TID; e < S * a.own; e += LD_NTID) a.g[S + e] = r[S + e];
    LD_CLUSTER_SYNC();
    for (int l = 0; l < f.levels; ++l) {
      forward(a, l);
      LD_CLUSTER_SYNC();
    }
    root(a, z);
    LD_CLUSTER_SYNC();
    for (int l = f.levels - 1; l >= 0; --l) {
      back(a, l, z);
      if (l > 0) {
        LD_CLUSTER_SYNC();
      } else {
        LD_SYNC();
      }
    }
    float part = 0.0f;
    for (int e = LD_TID; e < S * a.own; e += LD_NTID) part += r[S + e] * z[S + e];
    return part;
  }
};

}  // namespace bcr
