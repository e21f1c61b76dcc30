// The block cyclic reduction (BCR) of S lam = gamma, factored once and
// applied many times; shared by K6 (bcr_pcg_dz.cu, its CG's
// preconditioner), K7 (bcr_dz.cu: the refined solve + dz, cluster_bcr_dz),
// K7s (bcr_dz.cu, one unrefined solve) and K9b (sqp_mega.cu, the dual-solve
// stage of its per-iteration kernel: cluster_bcr_dz again) across one
// thread-block cluster (cluster_factor, ClusterBcr, below).  The one-block
// forms (bcr_factor, BcrPre, bcr_dz_body) are the references those equal
// bit for bit; no kernel runs them.
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
// N = 64), which stays in L2; the SPD inverses are lanedyn's register
// Gauss-Jordan (reg_spd_inverse: a row a lane, bit-equal to the
// shared-memory form), one warp per knot.  S's bands may be in shared or
// global memory.
#pragma once
#include "pcg_common.cuh"

namespace bcr {

constexpr int S = ld::NX, SS = S * S;
// 512 threads at most: K6's registers (96 a thread without a bound) times
// 896 threads would pass the SM's 65,536
constexpr int MAX_THREADS = 512, MAX_WARPS = MAX_THREADS / 32;
// Shared floats of the cluster factor's per-warp scratch (two 14x14 blocks
// a warp) for a block of `threads` threads, and for the largest block
LD_HD size_t scratch_floats(int threads) {
  return (size_t)2 * ((threads + 31) / 32) * SS;
}
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

// Shared floats of a warp's inverse: the 14x14 block and the register
// inverse's two pivot rows
constexpr int INV_FLOATS = SS + 2 * S;

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

// Warp gw of nw: Dinv[j] = D[j]^-1 for j = first + step t, t = gw,
// gw + nw, ...; A is the warp's 14x14 shared scratch and buf the register
// inverse's pivot rows (2 x 14 floats of shared memory).
LD_DEV void spread_inverses(const BcrFactor& f, int first, int step, int gw,
                            int nw, float* A, float* buf) {
  for (int j = first + gw * step; j < f.N; j += nw * step) {
    for (int e = ld::lane(); e < SS; e += ld::lanes()) A[e] = f.D[SS * j + e];
    ld::warp_sync();
    ld::reg_spd_inverse<S>(A, buf);
    for (int e = ld::lane(); e < SS; e += ld::lanes()) f.Dinv[SS * j + e] = A[e];
    ld::warp_sync();
  }
}

// Dinv[j] = D[j]^-1 for j = first, first + step, ... < N; one warp per knot
// of the block, each with INV_FLOATS of scratch.
LD_DEV void warp_inverses(const BcrFactor& f, int first, int step,
                          float* scratch) {
#ifdef __CUDACC__
  const int w = (int)threadIdx.x >> 5, nw = ((int)blockDim.x + 31) >> 5;
#else
  const int w = 0, nw = 1;
#endif
  float* A = scratch + INV_FLOATS * w;
  spread_inverses(f, first, step, w, nw, A, A + SS);
}

// The elimination, once per solve, from S's bands.  inv_scratch:
// INV_FLOATS of shared memory per warp.
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

// Shared floats of bcr_dz_body: lam, r, w, g (each (N, S)) and one
// inverse's scratch per warp.
LD_HD size_t dz_vec_floats(int N) {
  return (size_t)4 * N * S + (size_t)MAX_WARPS * INV_FLOATS;
}

// The TPU's _bcr_refined and its dz (bcr_kernel.py:107-120, 164-183) in
// one block: factor S into fac (factor_floats(N) of global scratch),
// lam = BCR(gamma), r = gamma - S lam, lam += BCR(r), then K4's dz
// epilogue; lam to lam_out.  vecs: dz_vec_floats(N) shared floats.  Ends
// in a barrier.  The reference cluster_bcr_dz equals (bcr_dz.cu
// mpc_bcr_dz_one_block_host, tools/cluster_factor_bench.cu).
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
// The cluster form (K6, K7, K7s, K9b): the same factor and apply spread over
// the C blocks of a thread-block cluster (pcg_common.cuh's ClusterCg: block
// r owns knots [r nk, r nk + own) and their S bands).  The factors stay in
// global memory (L2), laid out as above; another SM of the cluster may have
// written what a warp reads, and the cluster barrier between (release /
// acquire at cluster scope) makes those writes visible to ordinary loads.
// At each level the eliminated knots' inverses, then each (kept i,
// eliminated i + h) pair's products and kept-knot update, are taken one
// warp per knot or pair by all C x (warps per block) warps, with a cluster
// barrier after each: 2 log2(N) + 2 barriers.  A pair's products
// and its kept knot's update read nothing another pair writes, so one warp
// does both with a warp barrier between.  Each entry is bcr_factor's
// expression on the same operands, so the factors equal the one-block
// factor's bit for bit.  The apply (ClusterBcr) keeps g and z in the
// owners' shared memory and reads the rows at i +- h through DSMEM:
// log2(N) forward levels, the root, log2(N) back levels, a cluster barrier
// after each but the last.

// A lane's entries of a 14x14 block (ee = lane + lanes q, q = 0, 1, ...).
#ifdef __CUDACC__
constexpr int LANE_ENTRIES = (SS + 31) / 32;
#else
constexpr int LANE_ENTRIES = SS;
#endif
using Entries = float[LANE_ENTRIES];

// The lane's entries of the 14x14 block x (global memory) into r.
LD_DEV void fetch(Entries& r, const float* x) {
  const int ln = ld::lane(), lns = ld::lanes();
#pragma unroll
  for (int q = 0; q < LANE_ENTRIES; ++q)
    if (ln + lns * q < SS) r[q] = x[ln + lns * q];
}

// The warp's entries rx and ry (null: keep what is there) into its shared
// blocks sx and sy, between warp barriers.
LD_DEV void put(float* sx, const float* rx, float* sy, const float* ry) {
  const int ln = ld::lane(), lns = ld::lanes();
  ld::warp_sync();
#pragma unroll
  for (int q = 0; q < LANE_ENTRIES; ++q) {
    const int ee = ln + lns * q;
    if (ee >= SS) continue;
    if (rx) sx[ee] = rx[q];
    if (ry) sy[ee] = ry[q];
  }
  ld::warp_sync();
}

// Warp gw of nw at level l: for pairs t = gw, gw + nw, ... (kept
// i = 2 h t, eliminated j = i + h) the products LDm_i, UDp_i, DL_j, DU_j,
// then the kept knot's D_i, L_i, U_i: bcr_factor's expressions, each
// product's operands in the warp's shared blocks sx, sy.  Each operand
// block goes from L2 to the lanes' registers while the product before it
// runs, and LDm_i and UDp_i stay in registers for the kept knot's update,
// so a pair waits on L2 once, not once a product.
LD_DEV void spread_level(const BcrFactor& f, int l, int gw, int nw, float* sx,
                         float* sy) {
  const int h = 1 << l, n = f.N, nk = n / (2 * h), ln = ld::lane(),
            lns = ld::lanes();
  Entries a, b, c, m, d, lo, up;
  // each of the lane's entries of a product of the blocks in sx, sy
  auto each = [&](auto&& use) {
#pragma unroll
    for (int q = 0; q < LANE_ENTRIES; ++q)
      if (ln + lns * q < SS) use(q, ln + lns * q);
  };
  for (int t = gw; t < nk; t += nw) {
    const int i = 2 * h * t, j = i + h;
    const bool has_l = i >= h, has_u = j + h <= n - 1;
    float* LDm = f.LDm + (size_t)l * n * SS + SS * i;
    float* UDp = f.UDp + (size_t)l * n * SS + SS * i;
    // LDm_i = L_i Dinv_{i-h} (0 at the first pair)
    if (has_l) {
      fetch(a, f.L + SS * i);
      fetch(b, f.Dinv + SS * (i - h));
      put(sx, a, sy, b);
    }
    fetch(a, f.U + SS * i);
    fetch(b, f.Dinv + SS * j);
    each([&](int q, int ee) {
      m[q] = has_l ? mm(sx, sy, ee) : 0.0f;
      LDm[ee] = m[q];
    });
    // UDp_i = U_i Dinv_j
    put(sx, a, sy, b);
    fetch(a, f.L + SS * j);
    each([&](int q, int ee) {
      c[q] = mm(sx, sy, ee);
      UDp[ee] = c[q];
    });
    // DL_j = Dinv_j L_j, DU_j = Dinv_j U_j (0 at the last pair)
    put(sx, b, sy, a);
    fetch(b, f.U + SS * j);
    each([&](int, int ee) { f.DL[SS * j + ee] = mm(sx, sy, ee); });
    put(nullptr, nullptr, sy, b);
    fetch(d, f.D + SS * i);
    each([&](int, int ee) {
      f.DU[SS * j + ee] = has_u ? mm(sx, sy, ee) : 0.0f;
    });
    // the kept knot: U_i = -UDp_i U_{i+h},
    // D_i - UDp_i L_{i+h} - LDm_i U_{i-h}, L_i = -LDm_i L_{i-h}
    put(sx, c, nullptr, nullptr);
    if (has_l) fetch(b, f.U + SS * (i - h));
    each([&](int q, int ee) { up[q] = -mm(sx, sy, ee); });
    put(nullptr, nullptr, sy, a);
    if (has_l) fetch(c, f.L + SS * (i - h));
    each([&](int q, int ee) { d[q] -= mm(sx, sy, ee); });
    if (has_l) {
      put(sx, m, sy, b);
      each([&](int q, int ee) { d[q] -= mm(sx, sy, ee); });
      put(nullptr, nullptr, sy, c);
      each([&](int q, int ee) { lo[q] = -mm(sx, sy, ee); });
    } else {
      each([&](int q, int) { lo[q] = 0.0f; });
    }
    each([&](int q, int ee) {
      f.D[SS * i + ee] = d[q];
      f.L[SS * i + ee] = lo[q];
      f.U[SS * i + ee] = up[q];
    });
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
    spread_inverses(f, h, 2 * h, gw, nw, sx, sy);  // knots eliminated at l
    LD_CLUSTER_SYNC();
    spread_level(f, l, gw, nw, sx, sy);
    LD_CLUSTER_SYNC();
  }
  spread_inverses(f, 0, f.N, gw, nw, sx, sy);  // the root
  LD_CLUSTER_SYNC();
}

// Shared floats of one block of a one-cluster BCR kernel (K6, K7, K7s:
// blocks of MAX_THREADS) at cluster size C: its knots' S bands, the
// cluster CG's vectors and slots, two 14x14 blocks of scratch per warp.
LD_HD size_t cluster_floats(int N, int C) {
  return pcgc::cluster_cg_floats(N, C, false, SCRATCH_FLOATS);
}

#ifdef __CUDACC__
// The cluster size of a launch of the one-cluster BCR kernel fn over N
// knots (a power of 2 up to 2^16): `cluster` where it is 8 or 16 and fits;
// for cluster 0, 16 where the card can schedule a cluster of 16 blocks of
// fn (a non-portable size), else 8; 0 if none fits.  known: the caller's
// answers per device, log2 N and request (C + 1; 0 unasked).
inline int plan_cluster(const void* fn, int N, int cluster,
                        int (*known)[17][3]) {
  if (N < 1 || (N & (N - 1)) || N > (1 << 16)) return 0;
  if (cluster != 0 && cluster != 8 && cluster != 16) return 0;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= 16) return 0;
  int& c = known[dev][levels_of(N)][cluster / 8];
  if (c == 0) {
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      return 0;
    auto fits = [&](int C) {
      const size_t smem = cluster_floats(N, C) * sizeof(float);
      return smem <= (size_t)optin &&
             pcgc::active_clusters(fn, C, MAX_THREADS, smem) >= 1;
    };
    c = 1 + (cluster != 0 ? (fits(cluster) ? cluster : 0)
             : fits(16) ? 16 : fits(8) ? 8 : 0);
  }
  return c - 1;
}

// One launch of the one-cluster BCR kernel fn on a cluster of C blocks of
// MAX_THREADS threads; returns the launch's error.
template <class... P, class... A>
inline int launch_cluster(void (*fn)(P...), int N, int C, void* stream,
                          A... args) {
  const size_t smem = cluster_floats(N, C) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(MAX_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fn, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
#else
// The host build runs the cluster as one block: 1 where the card's
// arithmetic at 227 KB fits C = 16, else 0.
inline int host_cluster(int N) {
  if (N < 1 || (N & (N - 1)) || N > (1 << 16)) return 0;
  return cluster_floats(N, 16) * sizeof(float) <= 232448 ? 1 : 0;
}
#endif

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

// bcr_dz_body across the cluster (K7, and K9b's stage 4): factor S from
// the own knots' bands (a.SL, SD, SU) into f, lam = BCR(gamma),
// r = gamma - S lam (each owner's rows, the halo rows of lam read through
// DSMEM), lam += BCR(r), then the owners' dz (pcgc::cluster_dz); lam to
// lam_out.  Every sum keeps bcr_dz_body's terms, order and multiply-add
// pairing, so the outputs equal its bit for bit.  a.extra holds scratch_floats(threads);
// the vectors are a.r[0] (gamma, then r), a.lam and a.w.  Every block of
// the cluster calls it alike; ends in a cluster barrier.
LD_DEV void cluster_bcr_dz(const pcgc::ClusterCg& a, const BcrFactor& f,
                           const float* gamma, const float* A,
                           const float* B, const float* q, const float* r_in,
                           const float* Qinv, const float* Rinv,
                           float* lam_out, float* dX, float* dU) {
  cluster_factor(f, a, a.extra);
  float* const r = a.r[0];
  for (int e = LD_TID; e < S * a.own; e += LD_NTID) r[S + e] = gamma[S * a.k0 + e];
  LD_SYNC();
  const ClusterBcr pre{f};
  pre.apply(a, r, a.lam);
  LD_CLUSTER_SYNC();  // every owner's rows of lam are whole
  pcgc::fetch_halos(a, a.lam);
  LD_SYNC();
  for (int e = LD_TID; e < S * a.own; e += LD_NTID)
    r[S + e] -= pcgc::band_row_own(a, a.SL, a.SD, a.SU, a.lam, e / S, e % S);
  LD_SYNC();
  pre.apply(a, r, a.w);
  for (int e = LD_TID; e < S * a.own; e += LD_NTID) a.lam[S + e] += a.w[S + e];
  // no block reads another's w (the last back level) or lam past here
  LD_CLUSTER_SYNC();
  pcgc::cluster_dz(a, A, B, q, r_in, Qinv, Rinv, lam_out, dX, dU);
}

}  // namespace bcr
