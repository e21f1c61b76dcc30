// Per-knot rigid-body dynamics and small dense algebra for the Hopper kernels.
//
// Counterpart of mpcgpu_tpu/ops/pallas/lanedyn.py, the device library that
// the TPU kernels share.  There one knot is one lane of a vector register;
// here a knot is one thread or one thread block, and the routines below are
// straight-line scalar float32 code over small row-major arrays:
// ABA forward dynamics, RNEA, the hand-written RNEA tangents of
// rnea_lane_dtau_units, CRBA, end-effector FK with its position Jacobian,
// and a warp-parallel Gauss-Jordan SPD inverse (in place of the TPU's
// block-recursive form, which existed to keep VMEM graphs shallow).
//
// The robot is the 7-joint serial chain of models/robot.py: joint j's
// transforms are Xc + sin(q_j) Xs + cos(q_j) Xk (6x6, child <- parent) and
// Hc + sin Hs + cos Hk (4x4), every joint revolute about local z.  The
// tables travel as one float buffer (layout: TAB_* offsets, 1680 floats,
// 6720 B) that each block copies into shared memory.
//
// The same sources also build with a host C++ compiler (no __CUDACC__):
// a "block" is then one thread that runs every stride loop itself, which
// lets the arithmetic be checked against the plain PyTorch versions on a
// machine without a GPU.  A cooperative kernel (K5) launches one block
// there, which walks every knot of each stage in turn, so its grid
// barrier (LD_GRID_SYNC) is a no-op.  A thread-block cluster (K5, K9p,
// K6) is one block there too: its rank is 0, its size 1, the map into
// another block's shared memory (ld_cluster_map) returns the block's own,
// and the cluster barriers do nothing; a test may emulate C blocks whose
// phases between barriers it runs rank after rank (ld_emu_cbase).
#pragma once

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#define LD_DEV __device__ inline
#define LD_HD __host__ __device__ inline
#define LD_GLOBAL __global__
#define LD_LAUNCH_BOUNDS(threads) __launch_bounds__(threads)
#define LD_SHARED __shared__
#define LD_SYNC() __syncthreads()
#define LD_TID ((int)threadIdx.x)
#define LD_NTID ((int)blockDim.x)
#define LD_BID ((int)blockIdx.x)
#define LD_NBID ((int)gridDim.x)
#define LD_DYN_SMEM(name) extern __shared__ float name[]
#define LD_LAUNCH(kern, grid, block, smem, stream, ...) \
  kern<<<(grid), (block), (smem), (cudaStream_t)(stream)>>>(__VA_ARGS__)
#define LD_LAST_ERROR() ((int)cudaGetLastError())
#define LD_GRID_SYNC() cooperative_groups::this_grid().sync()
// The cluster barrier, whole or split in its arrive and wait halves (every
// thread of every block of the cluster arrives; release / acquire order the
// shared and global memory accesses around it).
#define LD_CLUSTER_SYNC() cooperative_groups::this_cluster().sync()
#define LD_CLUSTER_ARRIVE() \
  asm volatile("barrier.cluster.arrive.release;" ::: "memory")
#define LD_CLUSTER_WAIT() \
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory")
// This block's rank in its cluster and the cluster's size, as the hardware
// reports them (%cluster_ctarank, %cluster_nctarank).
__device__ inline int ld_cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}
__device__ inline int ld_cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return (int)n;
}
// The same shared-memory location in block `rank` of the cluster (DSMEM).
__device__ inline float* ld_cluster_map(const float* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(
      const_cast<float*>(p), (unsigned)rank);
}
#else
#include <math.h>
#include <vector>
#define LD_DEV inline
#define LD_HD inline
#define LD_GLOBAL static
#define LD_LAUNCH_BOUNDS(threads)
#define LD_SHARED static
#define LD_SYNC() ((void)0)
#define LD_TID 0
#define LD_NTID 1
#define LD_BID ld_emu_bid
#define LD_NBID ld_emu_nbid
inline int ld_emu_bid = 0;
inline int ld_emu_nbid = 1;
inline std::vector<float> ld_emu_smem;
#define LD_DYN_SMEM(name) float* name = ld_emu_smem.data()
#define LD_LAUNCH(kern, grid, block, smem, stream, ...)                    \
  do {                                                                     \
    ld_emu_smem.assign((size_t)(smem) / sizeof(float) + 1, 0.0f);          \
    (void)(block);                                                         \
    ld_emu_nbid = (grid);                                                  \
    for (ld_emu_bid = 0; ld_emu_bid < ld_emu_nbid; ++ld_emu_bid)           \
      kern(__VA_ARGS__);                                                   \
  } while (0)
#define LD_LAST_ERROR() 0
#define LD_GRID_SYNC() ((void)0)
#define LD_CLUSTER_SYNC() ((void)0)
#define LD_CLUSTER_ARRIVE() ((void)0)
#define LD_CLUSTER_WAIT() ((void)0)
// A cluster of one block, unless a host test emulates C blocks: it sets
// ld_emu_cbase to each block's shared memory and runs their phases rank
// after rank with ld_emu_crank set.
inline int ld_emu_crank = 0;
inline std::vector<float*> ld_emu_cbase;
inline int ld_cluster_rank() { return ld_emu_crank; }
inline int ld_cluster_size() {
  return ld_emu_cbase.empty() ? 1 : (int)ld_emu_cbase.size();
}
inline float* ld_cluster_map(const float* p, int rank) {
  if (ld_emu_cbase.empty()) return const_cast<float*>(p);
  return ld_emu_cbase[rank] + (p - ld_emu_cbase[ld_emu_crank]);
}
#endif

namespace ld {

// Work split inside a block.  On the card a "role" is one thread of its own
// warp and warp_* helpers run on the 32 lanes of one warp; in the host
// build the single thread takes every role and every lane.
#ifdef __CUDACC__
LD_DEV bool role(int r) { return (int)threadIdx.x == 32 * r; }
LD_DEV bool in_warp(int w) { return ((int)threadIdx.x >> 5) == w; }
LD_DEV int lane() { return (int)threadIdx.x & 31; }
LD_DEV int lanes() { return 32; }
LD_DEV void warp_sync() { __syncwarp(); }
#else
inline bool role(int) { return true; }
inline bool in_warp(int) { return true; }
inline int lane() { return 0; }
inline int lanes() { return 1; }
inline void warp_sync() {}
#endif

constexpr int NJ = 7;        // joints
constexpr int NQ = NJ;
constexpr int NX = 2 * NJ;   // state width
constexpr int NU = NJ;       // control width
constexpr int EZ = 2;        // S = e_z in the angular slot

// model table layout (floats)
constexpr int TAB_XC = 0;
constexpr int TAB_XS = TAB_XC + NJ * 36;
constexpr int TAB_XK = TAB_XS + NJ * 36;
constexpr int TAB_I = TAB_XK + NJ * 36;
constexpr int TAB_HC = TAB_I + NJ * 36;
constexpr int TAB_HS = TAB_HC + NJ * 16;
constexpr int TAB_HK = TAB_HS + NJ * 16;
constexpr int TAB_DHC = TAB_HK + NJ * 16;
constexpr int TAB_DHS = TAB_DHC + NJ * 16;
constexpr int TAB_DHK = TAB_DHS + NJ * 16;
constexpr int TAB_SIZE = TAB_DHK + NJ * 16;   // 1680

// Block-cooperative copy of the model tables into shared memory.
LD_DEV void load_tables(float* dst, const float* __restrict__ src) {
  for (int e = LD_TID; e < TAB_SIZE; e += LD_NTID) dst[e] = src[e];
  LD_SYNC();
}

// ---------------------------------------------------------------------------
// 6-vector spatial algebra
// ---------------------------------------------------------------------------

LD_DEV void joint_X(const float* tab, int j, float s, float c, float* X) {
  const float* xc = tab + TAB_XC + 36 * j;
  const float* xs = tab + TAB_XS + 36 * j;
  const float* xk = tab + TAB_XK + 36 * j;
#pragma unroll
  for (int e = 0; e < 36; ++e) X[e] = xc[e] + s * xs[e] + c * xk[e];
}

// d X_j / d q_j = cos(q) Xs - sin(q) Xk
LD_DEV void joint_dX(const float* tab, int j, float s, float c, float* dX) {
  const float* xs = tab + TAB_XS + 36 * j;
  const float* xk = tab + TAB_XK + 36 * j;
#pragma unroll
  for (int e = 0; e < 36; ++e) dX[e] = c * xs[e] - s * xk[e];
}

LD_DEV void mv6(const float* M, const float* v, float* out) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float acc = M[6 * i] * v[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) acc += M[6 * i + k] * v[k];
    out[i] = acc;
  }
}

LD_DEV void mtv6(const float* M, const float* v, float* out) {
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float acc = M[i] * v[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) acc += M[6 * k + i] * v[k];
    out[i] = acc;
  }
}

LD_DEV void cross3(const float* a, const float* b, float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// motion cross product (v x) m
LD_DEV void crm(const float* v, const float* m, float* out) {
  float t0[3], t1[3], t2[3];
  cross3(v, m, t0);
  cross3(v, m + 3, t1);
  cross3(v + 3, m, t2);
  out[0] = t0[0]; out[1] = t0[1]; out[2] = t0[2];
  out[3] = t1[0] + t2[0]; out[4] = t1[1] + t2[1]; out[5] = t1[2] + t2[2];
}

// force cross product (v x*) f
LD_DEV void crf(const float* v, const float* f, float* out) {
  float t0[3], t1[3], t2[3];
  cross3(v, f, t0);
  cross3(v + 3, f + 3, t1);
  cross3(v, f + 3, t2);
  out[0] = t0[0] + t1[0]; out[1] = t0[1] + t1[1]; out[2] = t0[2] + t1[2];
  out[3] = t2[0]; out[4] = t2[1]; out[5] = t2[2];
}

// crm(v) (S w) for S = e_z
LD_DEV void crm_z(const float* v, float w, float* out) {
  out[0] = v[1] * w; out[1] = -v[0] * w; out[2] = 0.0f;
  out[3] = v[4] * w; out[4] = -v[3] * w; out[5] = 0.0f;
}

LD_DEV void add6(float* a, const float* b) {
#pragma unroll
  for (int i = 0; i < 6; ++i) a[i] += b[i];
}

// X' A X for 6x6 X, A
LD_DEV void congruence_T(const float* X, const float* A, float* out) {
  float AX[36];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      float acc = A[6 * i] * X[j];
#pragma unroll
      for (int k = 1; k < 6; ++k) acc += A[6 * i + k] * X[6 * k + j];
      AX[6 * i + j] = acc;
    }
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      float acc = X[i] * AX[j];
#pragma unroll
      for (int k = 1; k < 6; ++k) acc += X[6 * k + i] * AX[6 * k + j];
      out[6 * i + j] = acc;
    }
}

// ---------------------------------------------------------------------------
// dynamics; s, c are sin(q), cos(q)
// ---------------------------------------------------------------------------

// Articulated-body algorithm (models/dynamics.forward_dynamics).
LD_DEV void aba_qdd(const float* tab, const float* s, const float* c,
                    const float* qd, const float* u, float grav, float* qdd) {
  const float* I = tab + TAB_I;
  float X[36];
  float cvel[NJ][6], pA[NJ][6], Uc[NJ][6], dc[NJ], uc[NJ];
  float v[6] = {0, 0, 0, 0, 0, 0};
  for (int j = 0; j < NJ; ++j) {
    float vn[6], Iv[6];
    joint_X(tab, j, s[j], c[j], X);
    mv6(X, v, vn);
    vn[EZ] += qd[j];
    crm_z(vn, qd[j], cvel[j]);
    mv6(I + 36 * j, vn, Iv);
    crf(vn, Iv, pA[j]);
    for (int i = 0; i < 6; ++i) v[i] = vn[i];
  }
  float IA[36];
  for (int e = 0; e < 36; ++e) IA[e] = I[36 * (NJ - 1) + e];
  for (int j = NJ - 1; j >= 0; --j) {
    for (int i = 0; i < 6; ++i) Uc[j][i] = IA[6 * i + EZ];
    dc[j] = Uc[j][EZ];
    uc[j] = u[j] - pA[j][EZ];
    if (j > 0) {
      float Ia[36], pa[6], t[6], C[36];
      for (int r = 0; r < 6; ++r)
        for (int q = 0; q < 6; ++q)
          Ia[6 * r + q] = IA[6 * r + q] - Uc[j][r] * Uc[j][q] / dc[j];
      mv6(Ia, cvel[j], t);
      float ud = uc[j] / dc[j];
      for (int i = 0; i < 6; ++i) pa[i] = pA[j][i] + t[i] + Uc[j][i] * ud;
      joint_X(tab, j, s[j], c[j], X);
      congruence_T(X, Ia, C);
      for (int e = 0; e < 36; ++e) IA[e] = I[36 * (j - 1) + e] + C[e];
      mtv6(X, pa, t);
      add6(pA[j - 1], t);
    }
  }
  float a[6] = {0, 0, 0, 0, 0, grav};
  for (int j = 0; j < NJ; ++j) {
    float an[6];
    joint_X(tab, j, s[j], c[j], X);
    mv6(X, a, an);
    add6(an, cvel[j]);
    float dot = Uc[j][0] * an[0];
    for (int i = 1; i < 6; ++i) dot += Uc[j][i] * an[i];
    qdd[j] = (uc[j] - dot) / dc[j];
    for (int i = 0; i < 6; ++i) a[i] = an[i];
    a[EZ] += qdd[j];
  }
}

// Recursive Newton-Euler: tau for (q, qd, qdd).
LD_DEV void rnea(const float* tab, const float* s, const float* c,
                 const float* qd, const float* qdd, float grav, float* tau) {
  const float* I = tab + TAB_I;
  float X[36], fs[NJ][6];
  float v[6] = {0, 0, 0, 0, 0, 0};
  float a[6] = {0, 0, 0, 0, 0, grav};
  for (int j = 0; j < NJ; ++j) {
    float vn[6], an[6], t[6], Iv[6];
    joint_X(tab, j, s[j], c[j], X);
    mv6(X, v, vn);
    vn[EZ] += qd[j];
    mv6(X, a, an);
    an[EZ] += qdd[j];
    crm_z(vn, qd[j], t);
    add6(an, t);
    mv6(I + 36 * j, an, fs[j]);
    mv6(I + 36 * j, vn, Iv);
    crf(vn, Iv, t);
    add6(fs[j], t);
    for (int i = 0; i < 6; ++i) { v[i] = vn[i]; a[i] = an[i]; }
  }
  float f[6];
  for (int i = 0; i < 6; ++i) f[i] = fs[NJ - 1][i];
  for (int j = NJ - 1; j >= 0; --j) {
    tau[j] = f[EZ];
    if (j > 0) {
      float t[6];
      joint_X(tab, j, s[j], c[j], X);
      mtv6(X, f, t);
      for (int i = 0; i < 6; ++i) f[i] = fs[j - 1][i] + t[i];
    }
  }
}

// Composite-rigid-body mass matrix M (NJ x NJ, row-major).
LD_DEV void crba(const float* tab, const float* s, const float* c, float* M) {
  const float* I = tab + TAB_I;
  float X[36], Ic[36], C[36], F[NJ][6];
  for (int e = 0; e < 36; ++e) Ic[e] = I[36 * (NJ - 1) + e];
  for (int i = 0; i < 6; ++i) F[NJ - 1][i] = Ic[6 * i + EZ];
  for (int j = NJ - 1; j > 0; --j) {
    joint_X(tab, j, s[j], c[j], X);
    congruence_T(X, Ic, C);
    for (int e = 0; e < 36; ++e) Ic[e] = I[36 * (j - 1) + e] + C[e];
    for (int i = 0; i < 6; ++i) F[j - 1][i] = Ic[6 * i + EZ];
  }
  for (int i = 0; i < NJ; ++i) M[NJ * i + i] = F[i][EZ];
  for (int j = NJ - 1; j > 0; --j) {
    joint_X(tab, j, s[j], c[j], X);
    for (int i = j; i < NJ; ++i) {
      float t[6];
      mtv6(X, F[i], t);
      for (int e = 0; e < 6; ++e) F[i][e] = t[e];
      M[NJ * i + (j - 1)] = t[EZ];
      M[NJ * (j - 1) + i] = t[EZ];
    }
  }
}

// The hand-written forward mode of lanedyn.rnea_lane_dtau_units: d tau /
// d(q, qd) at fixed qdd for the 2*NJ unit directions.  rnea_primal runs
// the primal RNEA chain once and keeps what the directions need; each
// direction (rnea_dtau_direction) then propagates only from its seed joint
// outward, so the directions are independent and can run in parallel.
struct RneaPrimal {
  float v_in[NJ][6], a_in[NJ][6], v[NJ][6], Iv[NJ][6], facc[NJ][6];
};

LD_DEV void rnea_primal(const float* tab, const float* s, const float* c,
                        const float* qd, const float* qdd, float grav,
                        RneaPrimal& P) {
  const float* I = tab + TAB_I;
  float X[36], fs[NJ][6];
  float vp[6] = {0, 0, 0, 0, 0, 0};
  float ap[6] = {0, 0, 0, 0, 0, grav};
  for (int j = 0; j < NJ; ++j) {
    float an[6], t[6];
    joint_X(tab, j, s[j], c[j], X);
    for (int i = 0; i < 6; ++i) { P.v_in[j][i] = vp[i]; P.a_in[j][i] = ap[i]; }
    mv6(X, vp, P.v[j]);
    P.v[j][EZ] += qd[j];
    mv6(X, ap, an);
    an[EZ] += qdd[j];
    crm_z(P.v[j], qd[j], t);
    add6(an, t);
    mv6(I + 36 * j, P.v[j], P.Iv[j]);
    mv6(I + 36 * j, an, fs[j]);
    crf(P.v[j], P.Iv[j], t);
    add6(fs[j], t);
    for (int i = 0; i < 6; ++i) { vp[i] = P.v[j][i]; ap[i] = an[i]; }
  }
  // backward force accumulators: facc[j] = f when the backward pass visits j
  float f[6];
  for (int i = 0; i < 6; ++i) f[i] = fs[NJ - 1][i];
  for (int j = NJ - 1; j >= 0; --j) {
    for (int i = 0; i < 6; ++i) P.facc[j][i] = f[i];
    if (j > 0) {
      float t[6];
      joint_X(tab, j, s[j], c[j], X);
      mtv6(X, f, t);
      for (int i = 0; i < 6; ++i) f[i] = fs[j - 1][i] + t[i];
    }
  }
}

// Direction d (d < NJ: dq_d, else dqd_{d-NJ}): dtau[i * stride] for joint i.
LD_DEV void rnea_dtau_direction(const float* tab, const float* s,
                                const float* c, const float* qd,
                                const RneaPrimal& P, int d, float* dtau,
                                int stride) {
  const float* I = tab + TAB_I;
  const bool pos = d < NJ;
  const int jd = pos ? d : d - NJ;
  float X[36], dX[36];
  float dv[6], da[6], dfs[NJ][6], t[6], Idv[6];
  if (pos) {
    joint_dX(tab, jd, s[jd], c[jd], dX);
    mv6(dX, P.v_in[jd], dv);
    mv6(dX, P.a_in[jd], da);
    crm_z(dv, qd[jd], t);
    add6(da, t);
  } else {
    for (int i = 0; i < 6; ++i) dv[i] = 0.0f;
    dv[EZ] = 1.0f;
    crm_z(P.v[jd], 1.0f, da);
  }
  // seed joint
  mv6(I + 36 * jd, da, dfs[jd]);
  crf(dv, P.Iv[jd], t);
  add6(dfs[jd], t);
  mv6(I + 36 * jd, dv, Idv);
  crf(P.v[jd], Idv, t);
  add6(dfs[jd], t);
  for (int j = jd + 1; j < NJ; ++j) {
    float dvn[6], dan[6];
    joint_X(tab, j, s[j], c[j], X);
    mv6(X, dv, dvn);
    mv6(X, da, dan);
    crm_z(dvn, qd[j], t);
    add6(dan, t);
    mv6(I + 36 * j, dan, dfs[j]);
    crf(dvn, P.Iv[j], t);
    add6(dfs[j], t);
    mv6(I + 36 * j, dvn, Idv);
    crf(P.v[j], Idv, t);
    add6(dfs[j], t);
    for (int i = 0; i < 6; ++i) { dv[i] = dvn[i]; da[i] = dan[i]; }
  }
  float df[6];
  for (int i = 0; i < 6; ++i) df[i] = dfs[NJ - 1][i];
  for (int j = NJ - 1; j >= 0; --j) {
    dtau[stride * j] = df[EZ];
    if (j > 0) {
      float dfn[6];
      joint_X(tab, j, s[j], c[j], X);
      mtv6(X, df, dfn);
      if (pos && j == jd) {
        mtv6(dX, P.facc[jd], t);
        add6(dfn, t);
      }
      if (j - 1 >= jd)
        for (int i = 0; i < 6; ++i) df[i] = dfs[j - 1][i] + dfn[i];
      else
        for (int i = 0; i < 6; ++i) df[i] = dfn[i];
    }
  }
}

// ---------------------------------------------------------------------------
// end-effector kinematics
// ---------------------------------------------------------------------------

LD_DEV void hom(const float* tab, int base, int j, float s, float c,
                float* H) {
  const float* hc = tab + base + 16 * j;
  const float* hs = tab + base + NJ * 16 + 16 * j;
  const float* hk = tab + base + 2 * NJ * 16 + 16 * j;
  for (int e = 0; e < 16; ++e) H[e] = hc[e] + s * hs[e] + c * hk[e];
}

LD_DEV void matmul4(const float* A, const float* B, float* out) {
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      float acc = A[4 * i] * B[j];
      for (int k = 1; k < 4; ++k) acc += A[4 * i + k] * B[4 * k + j];
      out[4 * i + j] = acc;
    }
}

// end-effector xyz
LD_DEV void fk_ee(const float* tab, const float* s, const float* c,
                  float* ee) {
  float T[16], H[16], Tn[16];
  hom(tab, TAB_HC, 0, s[0], c[0], T);
  for (int j = 1; j < NJ; ++j) {
    hom(tab, TAB_HC, j, s[j], c[j], H);
    matmul4(T, H, Tn);
    for (int e = 0; e < 16; ++e) T[e] = Tn[e];
  }
  ee[0] = T[3]; ee[1] = T[7]; ee[2] = T[11];
}

// end-effector xyz and its position Jacobian J (3 x NJ, row-major):
// column j = (H_0..H_{j-1} dH_j H_{j+1}..H_{NJ-1})[:3, 3]
LD_DEV void fk_ee_jac(const float* tab, const float* s, const float* c,
                      float* ee, float* J) {
  float H[16], P[16], Pn[16], dH[16];
  // sv[j] = (H_j .. H_{NJ-1})[:, 3]
  float sv[NJ + 1][4];
  sv[NJ][0] = 0.0f; sv[NJ][1] = 0.0f; sv[NJ][2] = 0.0f; sv[NJ][3] = 1.0f;
  for (int j = NJ - 1; j >= 0; --j) {
    hom(tab, TAB_HC, j, s[j], c[j], H);
    for (int i = 0; i < 4; ++i) {
      float acc = H[4 * i] * sv[j + 1][0];
      for (int k = 1; k < 4; ++k) acc += H[4 * i + k] * sv[j + 1][k];
      sv[j][i] = acc;
    }
  }
  for (int e = 0; e < 16; ++e) P[e] = (e % 5 == 0) ? 1.0f : 0.0f;
  for (int j = 0; j < NJ; ++j) {
    float w[4];
    hom(tab, TAB_DHC, j, s[j], c[j], dH);
    for (int i = 0; i < 4; ++i) {
      float acc = dH[4 * i] * sv[j + 1][0];
      for (int k = 1; k < 4; ++k) acc += dH[4 * i + k] * sv[j + 1][k];
      w[i] = acc;
    }
    for (int r = 0; r < 3; ++r) {
      float acc = P[4 * r] * w[0];
      for (int k = 1; k < 4; ++k) acc += P[4 * r + k] * w[k];
      J[NJ * r + j] = acc;
    }
    hom(tab, TAB_HC, j, s[j], c[j], H);
    matmul4(P, H, Pn);
    for (int e = 0; e < 16; ++e) P[e] = Pn[e];
  }
  ee[0] = P[3]; ee[1] = P[7]; ee[2] = P[11];
}

// ---------------------------------------------------------------------------
// small dense algebra (row-major)
// ---------------------------------------------------------------------------

// In-place inverse of an SPD n x n matrix A (shared memory, row-major) by
// Gauss-Jordan elimination without pivoting, one row per lane of a warp
// (the reference's in-shared-memory Gauss-Jordan, utils/matrix.cuh:122-238).
// Every lane of the warp must call it.
template <int n>
LD_DEV void warp_spd_inverse(float* A) {
  const int l = lane(), nl = lanes();
  for (int k = 0; k < n; ++k) {
    const float piv = A[n * k + k];
    warp_sync();
    for (int j = l; j < n; j += nl)
      A[n * k + j] = (j == k) ? 1.0f / piv : A[n * k + j] / piv;
    warp_sync();
    for (int i = l; i < n; i += nl) {
      if (i == k) continue;
      const float f = A[n * i + k];
      for (int j = 0; j < n; ++j)
        if (j != k) A[n * i + j] -= f * A[n * k + j];
      A[n * i + k] = -f / piv;
    }
    warp_sync();
  }
}

}  // namespace ld
