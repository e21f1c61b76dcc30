// The stair-PCG of S lam = gamma and the primal step, in two forms:
// - the one-block CG pieces (cg_init, cg_step, StairPre, dz_epilogue) that
//   K10's one-block form drives itself (sqp_mega_packed.cu: its arms' CGs
//   share one exit);
// - the cluster CG (cluster_cg_solve, cluster_dz): K6 (bcr_pcg_dz.cu, the
//   block cyclic reduction), K10's cluster form (one cluster an arm, the
//   exit shared by the arms' clusters: SharedExit), and the stair dual
//   solve (stair_dual_solve) that K5 and K9p run across their first
//   cluster, K5g and K9pg across every cluster of their launch (the
//   clusters joined by tagged words: JoinedExit), and K4 and K4b
//   (pcg_dz.cu) as a launch of their own in either form.
//
// In the one-block pieces one thread block holds S's three (N, 14, 14)
// bands and the CG vectors in shared memory; one thread per (knot, row)
// entry of an (N, 14) vector computes its 3x14-FMA band row, in strided
// loops when the block has fewer threads than entries.  The dot products
// reduce in a fixed order (warp shuffles, then warp 0) and every thread
// reads the one shared result, so all threads take the same exit decision.
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

// A float another block wrote in this launch, read past L1 (ld.global.cg).
LD_DEV float load_cg(const float* p) {
#ifdef __CUDACC__
  return __ldcg(p);
#else
  return *p;
#endif
}

// ---------------------------------------------------------------------------
// The cluster CG (K5, K9p, K4, K4b: the stair; K6: the block cyclic
// reduction): one thread-block cluster of C blocks on neighbouring SMs (C = 16 where the
// card schedules it, else 8).  Block r owns the knots [r nk, r nk + own),
// nk = ceil(N / C), and keeps their S bands (and the stair's, when they
// are on chip) and their rows of the CG vectors in its shared memory.  A
// vector is (nk + 2, 14) rows: row 0 holds the knot before the block's
// first, rows 1..own its own knots, row own + 1 the knot after its last
// (the halo rows a band row reads).  Every block has the same layout, so a
// row of another block's vector is the same offset in that block's shared
// memory, read through DSMEM (ld_cluster_map).
//
// Each dot product: every block sums its rows in a fixed order into one
// partial (block_partial, a slot in its shared memory); after a cluster
// barrier every block sums the C slots in rank order (cluster_sum), so every
// block holds the same bits and takes the same exit decision.  No atomics.
//
// MPCGPU algorithm 2 (warm start, exit at |eta| <= tol or the cap), with r
// and p double-buffered, so that a step takes two
// cluster barriers, not four:
//   w = S p, p.w partial | alpha; lam += alpha p; r' = r - alpha w, and r''s
//   halo rows from the neighbours' r and w; z = M^-1 r', r'.z partial |
//   eta', beta; p' = z + beta p, and p''s halo rows from the neighbours' z
//   and p.
// A neighbour's row of r' or p' is computed by the reader with the owner's
// expression on the owner's inputs (one fmaf), so both hold the same bits;
// the inputs stay unwritten until the reader is past the next barrier: r and
// p (the other buffers) are next written one barrier later, w and z after
// the barrier that follows their reads.  The two dot slots alternate the
// same way.  The M^-1 apply is the preconditioner's (ClusterStair here,
// bcr::ClusterBcr), which may hold cluster barriers of its own: every block
// calls it the same number of times.
//
// The joined form (K5g, K9pg, K4g, K4bg) runs the same body across the
// launch's G
// clusters of C blocks: block b = cl C + r (cluster cl, rank r) owns the
// knots [b N / (G C), (b + 1) N / (G C)) (the even cut, G C <= N: every
// block owns nk or nk - 1 knots, nk = ceil(N / (G C))), so at N = 1024 a
// block owns 3 knots (45 clusters of 8 on the H100) where one cluster of 16
// would give it 64.  Within a cluster it is the cluster CG; JoinedExit
// (below) joins the clusters with no grid barrier: each dot's cluster sum
// goes out as a tagged word that every block reads, and the rows at a
// cluster's edges go out as tagged words that the neighbouring cluster
// reads.  Past what shared memory holds, the stair's and S's bands are
// read from L2, and last the vectors too (joined_area's `place`).

// Knots per block of an N-knot solve over C blocks.
LD_HD int cluster_knots(int N, int C) { return (N + C - 1) / C; }

// First knot of block b of nb in the even cut of N knots.
LD_HD int even_start(int N, int nb, int b) {
  return (int)((long long)b * N / nb);
}

#ifdef __CUDACC__
// Co-resident clusters of C blocks of kernel fn, `threads` threads and
// `smem` dynamic shared bytes each (0 if none, or if the query is refused;
// C = 16 is allowed as a non-portable size).
inline int active_clusters(const void* fn, int C, int threads, size_t smem) {
  int n = 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) != cudaSuccess ||
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess)
    n = 0;
  cudaGetLastError();  // a refused query leaves no error behind
  return n;
}
#endif

// Shared floats of one block's area of nk knots: S's bands where `place`
// >= 2 and the stair's where `place` == 3, eight (nk + 2, 14) vectors where
// `place` >= 1, 32 reduction and 2 dot slots, then `extra` floats
// (ClusterCg::extra).
LD_HD size_t area_floats(int nk, int place, size_t extra) {
  const size_t bands = (size_t)(place >= 2) + (place == 3);
  return bands * 3 * nk * S * S
         + (place >= 1 ? (size_t)8 * (nk + 2) * S : 0) + 34 + extra;
}

// Shared floats of one block of the cluster form: S's bands of nk knots
// (and the stair's when `stair`), the vectors, the slots and `extra`.
LD_HD size_t cluster_cg_floats(int N, int C, bool stair, size_t extra) {
  return area_floats(cluster_knots(N, C), stair ? 3 : 2, extra);
}

// The joined form's shared floats of one block of nb at `place`
// (joined_area; extra: the block's copy of each dot and the rows at its
// cluster's edges, JoinedExit::total), and the global floats of its
// vectors at place 0.
LD_HD size_t joined_cg_floats(int N, int nb, int place) {
  return area_floats(cluster_knots(N, nb), place, 1 + 4 * S);
}
LD_HD size_t joined_vec_floats(int N, int nb) {
  return (size_t)8 * (cluster_knots(N, nb) + 2) * S;
}

struct ClusterCg {
  int N, C, rank, nk, k0, own;
  int G, cl, lo_row;     // clusters in the solve, this one's index, and the
                         // row of knot k0 - 1 in block rank - 1's vectors
  long long vstride;     // 0: vectors in shared memory; else the floats
                         // between two blocks' vectors in global memory
  float *SL, *SD, *SU;            // own knots' S bands (nk, 14, 14)
  float *PL, *PD, *PU;            // the stair's, where on chip
  float *lam, *w, *z, *g, *r[2], *p[2];   // (nk + 2, 14) each
  float *red, *slots, *extra;
};

// Lay out the area from smem: S's bands where place >= 2, the vectors (in
// gvec where it is not null), the slots, the stair's bands where place ==
// 3, then extra.
LD_DEV void lay_out(ClusterCg& a, float* smem, float* gvec, int place) {
  const size_t nb = (size_t)S * S * a.nk, nv = (size_t)S * (a.nk + 2);
  float* f = smem;
  a.SL = a.SD = a.SU = nullptr;
  if (place >= 2) {
    a.SL = f; f += nb;
    a.SD = f; f += nb;
    a.SU = f; f += nb;
  }
  float* v = gvec ? gvec : f;
  float** vecs[] = {&a.lam, &a.w, &a.z, &a.g, &a.r[0], &a.r[1], &a.p[0],
                    &a.p[1]};
  for (float** x : vecs) { *x = v; v += nv; }
  if (!gvec) f = v;
  a.red = f; f += 32;
  a.slots = f; f += 2;
  a.PL = a.PD = a.PU = nullptr;
  if (place == 3) {
    a.PL = f; f += nb;
    a.PD = f; f += nb;
    a.PU = f; f += nb;
  }
  a.extra = f;
}

// This block's part of an N-knot cluster solve laid out in smem
// (cluster_cg_floats(N, C, stair, ...) floats).
LD_DEV ClusterCg cluster_area(float* smem, int N, bool stair) {
  ClusterCg a;
  a.N = N;
  a.C = ld_cluster_size();
  a.rank = ld_cluster_rank();
  a.nk = cluster_knots(N, a.C);
  a.k0 = a.rank * a.nk;
  a.own = a.k0 >= N ? 0 : (N - a.k0 < a.nk ? N - a.k0 : a.nk);
  a.G = 1;
  a.cl = 0;
  a.lo_row = a.nk;
  a.vstride = 0;
  lay_out(a, smem, nullptr, stair ? 3 : 2);
  return a;
}

// This block's part of the joined form's N-knot solve over the launch's G
// clusters (the even cut; G C <= N), laid out by `place`: 3 S's and the
// stair's bands and the vectors on chip (joined_cg_floats of smem), 2 S's
// bands and the vectors, 1 the vectors, 0 none of them -- block b's vectors
// then at gvecs + b joined_vec_floats(N, G C) in global memory.  The caller
// points the bands that are not on chip at L2.
LD_DEV ClusterCg joined_area(float* smem, float* gvecs, int N, int G,
                             int place) {
  ClusterCg a;
  a.N = N;
  a.C = ld_cluster_size();
  a.rank = ld_cluster_rank();
  a.G = G;
  a.cl = LD_BID / a.C;
  const int nb = G * a.C, b = a.cl * a.C + a.rank;
  a.nk = cluster_knots(N, nb);
  a.k0 = even_start(N, nb, b);
  a.own = even_start(N, nb, b + 1) - a.k0;
  a.lo_row = b > 0 ? a.k0 - even_start(N, nb, b - 1) : 0;
  a.vstride = place == 0 ? (long long)joined_vec_floats(N, nb) : 0;
  lay_out(a, smem, place == 0 ? gvecs + a.vstride * b : nullptr, place);
  return a;
}

// Copy the own knots' rows of three (N, 14, 14) bands from global memory
// (read past L1: the stages before may have written them from other SMs)
// into L, D, U; ends in a block barrier.
LD_DEV void cluster_load_bands(const ClusterCg& a, const float* Lg,
                               const float* Dg, const float* Ug, float* L,
                               float* D, float* U) {
  const size_t o = (size_t)S * S * a.k0;
  for (int e = LD_TID; e < S * S * a.own; e += LD_NTID) {
    L[e] = load_cg(Lg + o + e);
    D[e] = load_cg(Dg + o + e);
    U[e] = load_cg(Ug + o + e);
  }
  LD_SYNC();
}

// Row i of knot k's band row: D x0 + L xm (k > 0) + U xp (k < N - 1), with
// band_row's order; Lr, Dr, Ur are the row's 14 entries of each block.
LD_DEV float band_row3(const float* Lr, const float* Dr, const float* Ur,
                       const float* xm, const float* x0, const float* xp,
                       int N, int k) {
  float acc = 0.0f;
  for (int j = 0; j < S; ++j) acc += Dr[j] * x0[j];
  if (k > 0)
    for (int j = 0; j < S; ++j) acc += Lr[j] * xm[j];
  if (k < N - 1)
    for (int j = 0; j < S; ++j) acc += Ur[j] * xp[j];
  return acc;
}

// Row i of own knot kl's band row of (L, D, U) (the own knots' bands)
// times the (nk + 2, 14) vector x.
LD_DEV float band_row_own(const ClusterCg& a, const float* L,
                          const float* D, const float* U, const float* x,
                          int kl, int i) {
  const int o = S * S * kl + S * i;
  return band_row3(L + o, D + o, U + o, x + S * kl, x + S * (kl + 1),
                   x + S * (kl + 2), a.N, a.k0 + kl);
}

// Knot k's row of the (nk + 2, 14) vector v, in whichever block owns k.
LD_DEV const float* knot_row(const ClusterCg& a, const float* v, int k) {
  const int q = k / a.nk, j = k - q * a.nk;
  return (q == a.rank ? v : ld_cluster_map(v, q)) + S * (j + 1);
}

// Entry i of row `row` of block q's vector v (v's offset in block q's
// area; q in this cluster): through DSMEM, or from global memory past L1.
LD_DEV float peer_at(const ClusterCg& a, const float* v, int q, int row,
                     int i) {
  if (a.vstride) return load_cg(v + (q - a.rank) * a.vstride + S * row + i);
  return ld_cluster_map(v, q)[S * row + i];
}

// The block's sum of v over its threads in a fixed order (warp shuffles,
// then warp 0), written to *slot; every thread calls it.
LD_DEV void block_partial(float v, float* red, float* slot) {
#ifdef __CUDACC__
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? red[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1) w += __shfl_down_sync(0xffffffffu, w, off);
    if (lane == 0) *slot = w;
  }
#else
  (void)red;
  *slot = v;
#endif
}

// The C blocks' values of `slot` summed in rank order: the same bits in
// every thread of every block.  Call after the cluster barrier that follows
// the slots' writes.
LD_DEV float cluster_sum(const ClusterCg& a, const float* slot) {
#ifdef __CUDACC__
  const int lane = threadIdx.x & 31;
  const float mine = lane < a.C ? *ld_cluster_map(slot, lane) : 0.0f;
  float s = 0.0f;
  for (int q = 0; q < a.C; ++q) s += __shfl_sync(0xffffffffu, mine, q);
  return s;
#else
  float s = 0.0f;
  for (int q = 0; q < a.C; ++q) s += *ld_cluster_map(slot, q);
  return s;
#endif
}

// Rows 0 and own + 1 of x copied from the neighbours' edge rows (where those
// knots exist).
LD_DEV void fetch_halos(const ClusterCg& a, float* x) {
  if (a.own == 0) return;
  for (int e = LD_TID; e < 2 * S; e += LD_NTID) {
    const bool hi = e >= S;
    const int k = hi ? a.k0 + a.own : a.k0 - 1, i = e % S;
    if (k >= 0 && k < a.N) x[S * (hi ? a.own + 1 : 0) + i] = knot_row(a, x, k)[i];
  }
}

// Rows 0 and own + 1 of y = s x + b (fmaf, as the owners compute their
// rows), from the neighbours' rows of x and b.
LD_DEV void halo_fma(const ClusterCg& a, float* y, float s, const float* x,
                     const float* b) {
  if (a.own == 0) return;
  for (int e = LD_TID; e < 2 * S; e += LD_NTID) {
    const bool hi = e >= S;
    const int k = hi ? a.k0 + a.own : a.k0 - 1, i = e % S;
    if (k >= 0 && k < a.N)
      y[S * (hi ? a.own + 1 : 0) + i] =
          fmaf(s, knot_row(a, x, k)[i], knot_row(a, b, k)[i]);
  }
}

// The stair preconditioner z = Pinv r over the own knots, from the own
// knots' stair bands (shared memory, or global memory at knot k0); returns
// this thread's part of r . z.  Ends in a block barrier.
struct ClusterStair {
  const float* PL;
  const float* PD;
  const float* PU;
  LD_DEV float apply(const ClusterCg& a, const float* r, float* z) const {
    float part = 0.0f;
    for (int e = LD_TID; e < S * a.own; e += LD_NTID) {
      const int kl = e / S, i = e % S;
      const float v = band_row_own(a, PL, PD, PU, r, kl, i);
      z[S + e] = v;
      part += r[S + e] * v;
    }
    LD_SYNC();
    return part;
  }
};

// The CG's exit.  LocalExit is MPCGPU algorithm 2's (K5, K9p, K4, K4b,
// K6): go on while it < max_iter and |eta| > tol, from this CG's own eta.
struct LocalExit {
  static constexpr bool SHARED = false, JOINED = false;
  int max_iter;
  float tol;
  LD_DEV bool may_step(int it, float eta) const {
    return it < max_iter && fabsf(eta) > tol;
  }
  LD_DEV void publish(const ClusterCg&, float) {}
  LD_DEV float div(float num, float den) const { return num / den; }
};

// SharedExit is the JAX packed kernel's (_pcg_loop_packed): B arms, each
// CG on a cluster of its own, step together while it < max_iter and some
// arm's |eta| > tol (none NaN: jnp.max(|eta|) > tol), one count for all,
// with cg_div's 0/0 -> 0 for alpha and beta (an arm whose residual is
// exactly zero freezes instead of making NaN).  After each eta's cluster
// sum, rank 0 of the arm's cluster publishes it beside its tag (the count
// of etas the arm has published in the launch) in one 64-bit word of
// global memory, double-buffered by the tag's parity.  The test of a step
// is taken after the step's w = S p (which changes neither lam nor r):
// warp 0 of every block reads the B words between the first cluster
// barrier's arrive and wait, until each carries the tag (a spin on L2:
// every cluster is co-resident, the launch is cooperative), so every
// block of every arm decides on the same bits, and the wait overlaps the
// barrier.  A word is overwritten two tags later, only after its arm has
// read every arm's next word, which each arm publishes only after all
// its blocks have read this one: no read can miss its tag.
#ifdef __CUDACC__
LD_DEV void store_tagged(unsigned long long* p, unsigned tag, float v) {
  const unsigned long long w =
      ((unsigned long long)tag << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(w)
               : "memory");
}
LD_DEV float wait_tagged(const unsigned long long* p, unsigned tag) {
  unsigned long long w;
  do {
    asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(w) : "l"(p)
                 : "memory");
  } while ((unsigned)(w >> 32) != tag);
  return __uint_as_float((unsigned)w);
}
#else
inline void store_tagged(unsigned long long* p, unsigned tag, float v) {
  unsigned bits;
  memcpy(&bits, &v, sizeof bits);
  *p = ((unsigned long long)tag << 32) | bits;
}
inline float wait_tagged(const unsigned long long* p, unsigned tag) {
  ld_emu_until([&] { return (unsigned)(*p >> 32) == tag; });
  const unsigned bits = (unsigned)*p;
  float v;
  memcpy(&v, &bits, sizeof v);
  return v;
}
#endif

struct SharedExit {
  static constexpr bool SHARED = true, JOINED = false;
  unsigned long long* words;  // 2 x B, zeroed before the launch's first CG
  int B, arm, max_iter;
  float tol;
  int* flag;          // shared memory: the test warp 0 took
  unsigned tag = 0;   // etas this arm has published in the launch
  LD_DEV bool may_step(int it, float) const { return it < max_iter; }
  LD_DEV void publish(const ClusterCg& a, float eta) {
    ++tag;
    if (a.rank == 0 && LD_TID == 0)
      store_tagged(words + (size_t)B * (tag & 1) + arm, tag, eta);
  }
  // warp 0 (one thread in the host build): every arm's eta of this tag
  LD_DEV void poll() {
#ifdef __CUDACC__
    const int lane = LD_TID, lanes = 32;
#else
    const int lane = LD_TID, lanes = 1;
#endif
    if (lane >= lanes) return;
    bool go = false, nan = false;
    for (int b = lane; b < B; b += lanes) {
      const float v = fabsf(wait_tagged(words + (size_t)B * (tag & 1) + b, tag));
      nan = nan || v != v;
      go = go || v > tol;
    }
#ifdef __CUDACC__
    go = __any_sync(0xffffffffu, go);
    nan = __any_sync(0xffffffffu, nan);
#endif
    if (lane == 0) *flag = go && !nan;
  }
  LD_DEV float div(float num, float den) const { return cg_div(num, den, true); }
};

// JoinedExit joins the G clusters of the joined form (K5g, K9pg, K4g,
// K4bg) into one CG: LocalExit's exit (LocalExit's test, on an eta every block of every
// cluster holds alike) and two exchanges across clusters, each through
// 64-bit words of global memory that carry a float beside a tag
// (store_tagged, wait_tagged; zeroed before the launch), with no grid
// barrier:
// - each dot (total): after the cluster barrier that follows the blocks'
//   partials, every block sums its cluster's partials in rank order, rank
//   0 publishes that sum as cluster cl's word of the dot's tag (the count
//   of dots in the launch), double-buffered by the tag's parity, and warp
//   0 of every block waits for the G words of the tag and sums them in one
//   fixed order (lane l the words l, l + 32, ... in turn, then a shuffle
//   tree): every block holds the same bits and takes the same exit.  A
//   word is overwritten two tags later, only after every block has read
//   it: a cluster publishes tag t + 2 only after its blocks have read
//   every cluster's word of tag t + 1, which a cluster publishes only after
//   its blocks have read tag t.
// - the halo rows at a cluster's edge (put, row): rank 0 puts its first
//   knot's row for cluster cl - 1 and rank C - 1 its last knot's for
//   cluster cl + 1, one tagged word a float: of r (kind 0) and z (kind 1)
//   at the start, of w and r after w = S p (kind 0), of p and z after
//   M^-1 (kind 1), and of the solution after the CG (kind 0, for dz).  The
//   reader builds its halo row from them with the owner's expression on the
//   owner's inputs (halo_fma's fmaf), so both hold the same bits.  The tag
//   is the count of puts of that kind; one buffer a kind suffices: the
//   reader takes a row before its cluster publishes the next dot, and the
//   owner puts the next row of that kind only after it has read the
//   dot's words.  In a step the rows put before a dot are read while
//   that dot's words are awaited (total's `kind`): warp 1 of an edge
//   block waits for them beside warp 0, into shared memory, so the halo
//   rows after the dot cost no second wait on L2.
// Words: 2 G dot words, then 112 a cluster (its first knot's rows, then
// its last's; kind 0, then 1; x, then y; 14 each).
LD_HD size_t joined_words(int G) { return (size_t)114 * G; }

struct JoinedExit {
  static constexpr bool SHARED = false, JOINED = true;
  unsigned long long* words;  // joined_words(G), zeroed before the launch
  int G, max_iter;
  float tol;
  unsigned dots = 0, puts[2] = {0, 0};  // tags: this launch's counts
  LD_DEV bool may_step(int it, float eta) const {
    return it < max_iter && fabsf(eta) > tol;
  }
  LD_DEV void publish(const ClusterCg&, float) {}
  LD_DEV float div(float num, float den) const { return num / den; }
  LD_DEV unsigned long long* rows(int cl, bool last, int kind) const {
    return words + 2 * (size_t)G + 112 * (size_t)cl + 56 * last + 28 * kind;
  }
  // Whether the knot before this block's first (hi: after its last) lies
  // in another cluster.
  LD_DEV bool outside(const ClusterCg& a, bool hi) const {
    return hi ? a.rank == a.C - 1 && a.cl < G - 1 : a.rank == 0 && a.cl > 0;
  }
  // The dot whose block partials are in `slot`, over the G clusters; call
  // after the cluster barrier that follows the partials' writes.  With
  // kind >= 0 the last put rows of that kind at this block's edges are
  // read meanwhile (fetched).  Ends in a block barrier.
  LD_DEV float total(const ClusterCg& a, const float* slot, int kind = -1) {
    const float s = cluster_sum(a, slot);
    if (G == 1) return s;
    ++dots;
    unsigned long long* const w = words + (size_t)G * (dots & 1);
    if (a.rank == 0 && LD_TID == 0) store_tagged(w + a.cl, dots, s);
#ifdef __CUDACC__
    if (LD_TID < 32) {
      float v = 0.0f;
      for (int q = LD_TID; q < G; q += 32) v += wait_tagged(w + q, dots);
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (LD_TID == 0) *a.extra = v;
    } else if (kind >= 0 && LD_TID < 32 + 4 * S) {
      fetch(a, kind, LD_TID - 32);
    }
#else
    if (LD_TID == 0) {
      float v[32] = {};
      for (int q = 0; q < G; ++q) v[q % 32] += wait_tagged(w + q, dots);
      for (int off = 16; off > 0; off >>= 1)
        for (int l = 0; l < off; ++l) v[l] += v[l + off];
      *a.extra = v[0];
      if (kind >= 0)
        for (int e = 0; e < 4 * S; ++e) fetch(a, kind, e);
    }
#endif
    LD_SYNC();
    return *a.extra;
  }
  // Entry e of the rows total() reads: the knot before this block's first
  // (e < 2 S) or after its last, vector x then y, 14 entries each.
  LD_DEV void fetch(const ClusterCg& a, int kind, int e) const {
    const bool hi = e >= 2 * S;
    if (outside(a, hi)) a.extra[1 + e] = row(a, kind, hi, (e / S) & 1, e % S);
  }
  LD_DEV float fetched(const ClusterCg& a, bool hi, int v, int i) const {
    return a.extra[1 + 2 * S * hi + S * v + i];
  }
  // Put this block's edge rows of x (and y, unless null) where the
  // neighbouring clusters read them.  Every block calls it alike, after a
  // block barrier that follows the rows' writes.
  LD_DEV void put(const ClusterCg& a, int kind, const float* x,
                  const float* y) {
    const unsigned tag = ++puts[kind];
    const bool first = outside(a, false), last = outside(a, true);
    if (!first && !last) return;
    for (int e = LD_TID; e < 4 * S; e += LD_NTID) {
      const bool hi = e >= 2 * S;
      const int v = (e / S) & 1, i = e % S;
      const float* src = v ? y : x;
      if ((hi ? last : first) && src)
        store_tagged(rows(a.cl, hi, kind) + S * v + i, tag,
                     src[S * (hi ? a.own : 1) + i]);
    }
  }
  // Entry i of vector v (0 x, 1 y) of the last put of `kind` of the knot
  // before this block's first (hi: after its last), from the neighbouring
  // cluster.
  LD_DEV float row(const ClusterCg& a, int kind, bool hi, int v,
                   int i) const {
    return wait_tagged(rows(a.cl + (hi ? 1 : -1), !hi, kind) + S * v + i,
                       puts[kind]);
  }
};

// The dot whose block partials are in `slot`, after the cluster barrier
// that follows their writes: the cluster's rank-ordered sum, or the joined
// form's sum over its clusters (reading meanwhile the rows of `kind` at
// the block's edges, -1 none, for halo_fma).
template <class Exit>
LD_DEV float dot_sum(const ClusterCg& a, const float* slot, Exit& ex,
                     int kind = -1) {
  if constexpr (Exit::JOINED) return ex.total(a, slot, kind);
  else return cluster_sum(a, slot);
}

// fetch_halos, and halo_fma, under the exit `ex`: in the joined form a
// halo row comes from the neighbouring block, in this cluster (DSMEM or
// global memory) or put by the next or previous cluster: for
// fetch_halos the last put of kind `kind`, for halo_fma the rows the dot
// before it fetched.
template <class Exit>
LD_DEV void fetch_halos(const ClusterCg& a, float* x, const Exit& ex,
                        int kind) {
  if constexpr (!Exit::JOINED) {
    fetch_halos(a, x);
  } else {
    for (int e = LD_TID; e < 2 * S; e += LD_NTID) {
      const bool hi = e >= S;
      const int k = hi ? a.k0 + a.own : a.k0 - 1, i = e % S;
      if (k < 0 || k >= a.N) continue;
      x[S * (hi ? a.own + 1 : 0) + i] =
          ex.outside(a, hi)
              ? ex.row(a, kind, hi, 0, i)
              : peer_at(a, x, a.rank + (hi ? 1 : -1), hi ? 1 : a.lo_row, i);
    }
  }
}

template <class Exit>
LD_DEV void halo_fma(const ClusterCg& a, float* y, float s, const float* x,
                     const float* b, const Exit& ex) {
  if constexpr (!Exit::JOINED) {
    halo_fma(a, y, s, x, b);
  } else {
    for (int e = LD_TID; e < 2 * S; e += LD_NTID) {
      const bool hi = e >= S;
      const int k = hi ? a.k0 + a.own : a.k0 - 1, i = e % S;
      if (k < 0 || k >= a.N) continue;
      const int q = a.rank + (hi ? 1 : -1), row = hi ? 1 : a.lo_row;
      const bool out = ex.outside(a, hi);
      y[S * (hi ? a.own + 1 : 0) + i] =
          fmaf(s, out ? ex.fetched(a, hi, 0, i) : peer_at(a, x, q, row, i),
               out ? ex.fetched(a, hi, 1, i) : peer_at(a, b, q, row, i));
    }
  }
}

// The warm-started preconditioned CG (MPCGPU alg. 2) over the cluster,
// every block calling it alike, with the exit `ex` (LocalExit: MPCGPU's;
// SharedExit: the packed arms'; JoinedExit: one CG over the joined form's
// clusters): S's own bands in a.SL, SD, SU (shared or global memory), gamma and
// lam0 in global memory (lam0 read past L1, whole: the first residual
// reads the neighbours' rows).  The solution's own rows end in a.lam;
// returns the iteration count and the final eta.
template <class Pre, class Exit>
LD_DEV int cluster_cg_solve(const ClusterCg& a, const float* gamma,
                            const float* lam0, const Pre& pre, Exit& ex,
                            float* eta_out) {
  const int t = LD_TID, nt = LD_NTID, n = S * a.own;
  float* const lam = a.lam;
  float* const w = a.w;
  float* const z = a.z;
  // r = gamma - S lam0
  for (int e = t; e < n; e += nt) {
    const int kl = e / S, i = e % S, k = a.k0 + kl, o = S * S * kl + S * i;
    float xm[S], x0[S], xp[S];
    for (int j = 0; j < S; ++j) {
      x0[j] = load_cg(lam0 + S * k + j);
      xm[j] = k > 0 ? load_cg(lam0 + S * (k - 1) + j) : 0.0f;
      xp[j] = k < a.N - 1 ? load_cg(lam0 + S * (k + 1) + j) : 0.0f;
    }
    a.r[0][S + e] = load_cg(gamma + S * k + i)
                    - band_row3(a.SL + o, a.SD + o, a.SU + o, xm, x0, xp, a.N, k);
    lam[S + e] = x0[i];
  }
  if constexpr (Exit::JOINED) {
    LD_SYNC();
    ex.put(a, 0, a.r[0], nullptr);
  }
  LD_CLUSTER_SYNC();
  fetch_halos(a, a.r[0], ex, 0);
  LD_SYNC();
  // z = M^-1 r, p = z, eta = r . z
  float part = pre.apply(a, a.r[0], z);
  for (int e = t; e < n; e += nt) a.p[0][S + e] = z[S + e];
  if constexpr (Exit::JOINED) ex.put(a, 1, z, nullptr);
  block_partial(part, a.red, a.slots + 1);
  LD_CLUSTER_SYNC();
  float eta = dot_sum(a, a.slots + 1, ex);
  ex.publish(a, eta);
  fetch_halos(a, a.p[0], ex, 1);
  LD_SYNC();
  int it = 0, c = 0;
  while (ex.may_step(it, eta)) {
    const float* P = a.p[c];
    const float* R = a.r[c];
    float* Pn = a.p[c ^ 1];
    float* Rn = a.r[c ^ 1];
    // w = S p, alpha = eta / p . w
    part = 0.0f;
    for (int e = t; e < n; e += nt) {
      const float v = band_row_own(a, a.SL, a.SD, a.SU, P, e / S, e % S);
      w[S + e] = v;
      part += P[S + e] * v;
    }
    block_partial(part, a.red, a.slots);
    if constexpr (Exit::JOINED) ex.put(a, 0, w, R);
    if constexpr (Exit::SHARED) {
      LD_CLUSTER_ARRIVE();
      ex.poll();
      LD_CLUSTER_WAIT();
      LD_SYNC();
      if (!*ex.flag) break;
    } else {
      LD_CLUSTER_SYNC();
    }
    const float alpha = ex.div(eta, dot_sum(a, a.slots, ex, 0));
    // lam += alpha p, r' = r - alpha w (own rows and halos)
    for (int e = t; e < n; e += nt) {
      lam[S + e] = fmaf(alpha, P[S + e], lam[S + e]);
      Rn[S + e] = fmaf(-alpha, w[S + e], R[S + e]);
    }
    halo_fma(a, Rn, -alpha, w, R, ex);
    LD_SYNC();
    // z = M^-1 r', eta' = r' . z
    part = pre.apply(a, Rn, z);
    if constexpr (Exit::JOINED) ex.put(a, 1, P, z);
    block_partial(part, a.red, a.slots + 1);
    LD_CLUSTER_SYNC();
    const float eta_new = dot_sum(a, a.slots + 1, ex, 1);
    ex.publish(a, eta_new);
    const float beta = ex.div(eta_new, eta);
    // p' = z + beta p (own rows and halos)
    for (int e = t; e < n; e += nt) Pn[S + e] = fmaf(beta, P[S + e], z[S + e]);
    halo_fma(a, Pn, beta, P, z, ex);
    LD_SYNC();
    eta = eta_new;
    ++it;
    c ^= 1;
  }
  *eta_out = eta;
  return it;
}

template <class Pre>
LD_DEV int cluster_cg_solve(const ClusterCg& a, const float* gamma,
                            const float* lam0, const Pre& pre, int max_iter,
                            float tol, float* eta_out) {
  LocalExit ex{max_iter, tol};
  return cluster_cg_solve(a, gamma, lam0, pre, ex, eta_out);
}

// The primal step (dz_epilogue's arithmetic in the same order) over the own
// knots from a.lam, lam_{k+1} of the last one read from the next block;
// writes lam to lam_out unless it is null.  The halo read is the last
// access to another block's shared memory: the block arrives at the cluster
// barrier right after it and waits at the end, so no block leaves (or
// reuses its shared memory) while another may still read it, and the dz
// overlaps the wait.  In the joined form (JoinedExit) the lam rows at the
// clusters' edges are put and read as the CG's halo rows are.
template <class Exit>
LD_DEV void cluster_dz(const ClusterCg& a, const float* A, const float* B,
                       const float* q, const float* r_in, const float* Qinv,
                       const float* Rinv, float* lam_out, float* dX,
                       float* dU, Exit& ex) {
  const int t = LD_TID, nt = LD_NTID, N = a.N, k0 = a.k0;
  const float* lam = a.lam;
  if constexpr (Exit::JOINED) ex.put(a, 0, a.lam, nullptr);
  if (a.own > 0 && k0 + a.own < N)
    for (int e = t; e < S; e += nt) {
      if constexpr (Exit::JOINED)
        a.lam[S * (a.own + 1) + e] = ex.outside(a, true)
                                         ? ex.row(a, 0, true, 0, e)
                                         : peer_at(a, a.lam, a.rank + 1, 1, e);
      else
        a.lam[S * (a.own + 1) + e] = knot_row(a, a.lam, k0 + a.own)[e];
    }
  LD_CLUSTER_ARRIVE();
  LD_SYNC();
  float* const rx = a.w + S;
  float* const ru = a.g + S;
  for (int e = t; e < S * a.own; e += nt) {
    const int kl = e / S, i = e % S, k = k0 + kl;
    float acc = q[S * k + i] - lam[S + e];
    if (k < N - 1)
      for (int m = 0; m < S; ++m)
        acc += A[S * S * k + S * m + i] * lam[S * (kl + 2) + m];
    rx[e] = acc;
    if (lam_out) lam_out[S * k + i] = lam[S + e];
  }
  for (int e = t; e < NU * a.own; e += nt) {
    const int kl = e / NU, i = e % NU, k = k0 + kl;
    if (k >= N - 1) continue;
    float acc = r_in[NU * k + i];
    for (int m = 0; m < S; ++m)
      acc += B[S * NU * k + NU * m + i] * lam[S * (kl + 2) + m];
    ru[e] = acc;
  }
  LD_SYNC();
  for (int e = t; e < S * a.own; e += nt) {
    const int kl = e / S, i = e % S, k = k0 + kl;
    float acc = 0.0f;
    for (int j = 0; j < S; ++j) acc += Qinv[S * S * k + S * i + j] * rx[S * kl + j];
    dX[S * k + i] = -acc;
  }
  for (int e = t; e < NU * a.own; e += nt) {
    const int kl = e / NU, i = e % NU, k = k0 + kl;
    if (k >= N - 1) continue;
    float acc = 0.0f;
    for (int j = 0; j < NU; ++j) acc += Rinv[NU * NU * k + NU * i + j] * ru[NU * kl + j];
    dU[NU * k + i] = -acc;
  }
  LD_CLUSTER_WAIT();
}

LD_DEV void cluster_dz(const ClusterCg& a, const float* A, const float* B,
                       const float* q, const float* r_in, const float* Qinv,
                       const float* Rinv, float* lam_out, float* dX,
                       float* dU) {
  LocalExit ex{0, 0.0f};
  cluster_dz(a, A, B, q, r_in, Qinv, Rinv, lam_out, dX, dU, ex);
}

// The inputs of the stair dual solve, in global memory: S's and the
// stair's bands ((N, 14, 14) each), gamma and the warm start lam0 ((N, 14));
// and, for the primal step, A, B, q, r, Qinv and Rinv as dz_epilogue reads
// them.
struct DualIn {
  const float *SL, *SD, *SU, *PL, *PD, *PU, *gamma, *lam0;
  const float *A, *B, *q, *r, *Qinv, *Rinv;
};

// The stair dual solve, every block of the solve calling it alike: the
// warm-started stair-PCG of S lam = gamma from lam0, then the primal step
// into dX and dU when DZ (cluster_dz, which also writes lam to lam_out),
// else lam alone into lam_out.  `a` is this block's area: cluster_area's
// (one cluster; place 3 with the stair's bands on chip, 2 with them read
// from L2) or joined_area's at `place` (every cluster of the launch, ex a
// JoinedExit); the bands that the place keeps on chip are loaded into it
// from L2 first, the others are read where they lie.  K5 and K9p run it
// across their first cluster, K5g and K9pg across every cluster, as their
// stage 4; K4, K4b, K4g and K4bg as a launch of their own.  Returns the CG
// count; the final eta in *eta_out.  The block's last access to another
// block's shared memory comes before a cluster barrier that every block
// passes, so no block leaves while another may still read it.
template <bool DZ, class Exit>
LD_DEV int stair_dual_solve(ClusterCg& a, int place, const DualIn& in,
                            Exit& ex, float* lam_out, float* dX, float* dU,
                            float* eta_out) {
  const size_t o = (size_t)S * S * a.k0;
  if (place >= 2) {
    cluster_load_bands(a, in.SL, in.SD, in.SU, a.SL, a.SD, a.SU);
  } else {
    a.SL = const_cast<float*>(in.SL) + o;
    a.SD = const_cast<float*>(in.SD) + o;
    a.SU = const_cast<float*>(in.SU) + o;
  }
  ClusterStair pre{in.PL + o, in.PD + o, in.PU + o};
  if (place == 3) {
    cluster_load_bands(a, in.PL, in.PD, in.PU, a.PL, a.PD, a.PU);
    pre = ClusterStair{a.PL, a.PD, a.PU};
  }
  const int its = cluster_cg_solve(a, in.gamma, in.lam0, pre, ex, eta_out);
  if constexpr (DZ) {
    cluster_dz(a, in.A, in.B, in.q, in.r, in.Qinv, in.Rinv, lam_out, dX, dU,
               ex);
  } else {
    LD_CLUSTER_ARRIVE();
    for (int e = LD_TID; e < S * a.own; e += LD_NTID)
      lam_out[S * a.k0 + e] = a.lam[S + e];
    LD_CLUSTER_WAIT();
  }
  return its;
}

}  // namespace pcgc
