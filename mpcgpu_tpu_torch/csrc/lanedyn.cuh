// Per-knot rigid-body dynamics and small dense algebra for the Hopper kernels.
//
// Counterpart of mpcgpu_tpu/ops/pallas/lanedyn.py, the device library that
// the TPU kernels share.  There one knot is one lane of a vector register;
// here a knot is one thread block (K3, K5), one warp (K1) or one group of
// 8-32 lanes (K2's merit contribution, merit.cuh), and every recursion is
// warp-cooperative: the joint order stays sequential, and inside each joint
// the spatial algebra -- the 6x6 transform and its 6-vector products, the
// congruence X' A X (36 outputs), the rank-1 articulated-inertia update, crf
// and crm -- is spread over the lanes of a group (Lanes), one output entry a
// lane, each entry's sum in a fixed term order (the first term a product,
// each later one a multiply-add), with the intermediates in shared memory
// and a group barrier between dependent steps.  The routines: ABA forward
// dynamics (aba), RNEA with what the tangents need (rnea), the hand-written
// RNEA tangents of rnea_lane_dtau_units (rnea_dtau_direction), CRBA (crba),
// end-effector FK with its position Jacobian (fk_ee_jac; the position alone
// when J is null), and SPD inverses: reg_spd_inverse keeps a row a lane in
// registers and passes the pivot row through a small shared buffer;
// warp_spd_inverse, the shared-memory Gauss-Jordan that K6's and K7's
// factors share (they must stay bit-equal), stays for them.  There is one
// form of each recursion.
//
// The robot is the 7-joint serial chain of models/robot.py: joint j's
// transforms are Xc + sin(q_j) Xs + cos(q_j) Xk (6x6, child <- parent) and
// Hc + sin Hs + cos Hk (4x4), every joint revolute about local z.  The
// tables travel as one float buffer (layout: TAB_* offsets, 1680 floats,
// 6720 B) that each block copies into shared memory.
//
// The same sources also build with a host C++ compiler (no __CUDACC__):
// a "block" is then one thread that runs every stride loop itself and
// takes every role and every lane, which lets the arithmetic be checked
// against the plain PyTorch versions on a machine without a GPU.  A
// cooperative kernel (K5) launches one block there, which walks every
// knot of each stage in turn, so its grid barrier (LD_GRID_SYNC) is a
// no-op.  A thread-block cluster (K5, K9p, K6) is one block there too: its
// rank is 0, its size 1, the map into another block's shared memory
// (ld_cluster_map) returns the block's own, and the cluster barriers do
// nothing; a test may emulate C blocks whose phases between barriers it
// runs rank after rank (ld_emu_cbase).  A test may also emulate a block's
// threads (ld_emu_threaded): each launch then runs every block on as many
// host threads as the launch names, 32 lanes a warp, with the static
// shared arrays shared and the block, warp and group barriers real (a
// generation barrier per group) -- the check that a routine's split over
// lanes is right, which one thread cannot show.
#pragma once

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#define LD_DEV __device__ inline
#define LD_FORCE __device__ __forceinline__
#define LD_NOINLINE static __device__ __noinline__
#define LD_HD __host__ __device__ inline
#define LD_GLOBAL __global__
#define LD_LAUNCH_BOUNDS(threads) __launch_bounds__(threads)
#ifndef LD_MAXNREG  // a build may lift the caps to read the kernels' own counts
#define LD_MAXNREG(n) __maxnreg__(n)
#endif
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
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <map>
#include <mutex>
#include <thread>
#include <vector>
#define LD_DEV inline
#define LD_FORCE inline
#define LD_NOINLINE static inline
#define LD_HD inline
#define LD_GLOBAL static
#define LD_LAUNCH_BOUNDS(threads)
#define LD_MAXNREG(n)
#define LD_SHARED static
#define LD_SYNC() ld_emu_barrier(0, ld_emu_ntid)
#define LD_TID ld_emu_tid
#define LD_NTID ld_emu_ntid
#define LD_BID ld_emu_bid
#define LD_NBID ld_emu_nbid
inline int ld_emu_bid = 0;
inline int ld_emu_nbid = 1;
inline std::vector<float> ld_emu_smem;
// The emulated block's threads: one unless a test sets ld_emu_threaded,
// and then as many as each launch names (ld_emu_run).
inline bool ld_emu_threaded = false;
inline int ld_emu_ntid = 1;
inline thread_local int ld_emu_tid = 0;
// Set when an emulated barrier waited past its deadline (a thread that
// never arrives: a barrier in a branch only some threads take); every
// barrier then returns at once, and the test entry reports the fault.
inline std::atomic<bool> ld_emu_failed{false};

struct LdEmuBarrier {
  std::mutex m;
  std::condition_variable cv;
  int arrived = 0;
  long long gen = 0;
};
inline std::mutex ld_emu_bars_m;
inline std::map<long long, LdEmuBarrier> ld_emu_bars;

// The barrier of the `count` emulated threads from thread `first` on.
inline void ld_emu_barrier(int first, int count) {
  if (count <= 1 || ld_emu_failed) return;
  LdEmuBarrier* b;
  {
    std::lock_guard<std::mutex> lk(ld_emu_bars_m);
    b = &ld_emu_bars[((long long)first << 20) | count];
  }
  std::unique_lock<std::mutex> lk(b->m);
  const long long gen = b->gen;
  if (++b->arrived == count) {
    b->arrived = 0;
    ++b->gen;
    b->cv.notify_all();
    return;
  }
  if (!b->cv.wait_for(lk, std::chrono::seconds(30),
                      [&] { return b->gen != gen; }))
    ld_emu_failed = true;
}

// Run one block's body on `threads` emulated threads (or on this thread).
template <class F>
inline void ld_emu_run(int threads, F&& body) {
  if (!ld_emu_threaded || threads <= 1) {
    body();
    return;
  }
  ld_emu_ntid = threads;
  std::vector<std::thread> pool;
  for (int i = 0; i < threads; ++i)
    pool.emplace_back([&body, i] {
      ld_emu_tid = i;
      body();
    });
  for (auto& th : pool) th.join();
  ld_emu_ntid = 1;
}

#define LD_DYN_SMEM(name) float* name = ld_emu_smem.data()
#define LD_LAUNCH(kern, grid, block, smem, stream, ...)                    \
  do {                                                                     \
    ld_emu_smem.assign((size_t)(smem) / sizeof(float) + 1, 0.0f);          \
    ld_emu_nbid = (grid);                                                  \
    for (ld_emu_bid = 0; ld_emu_bid < ld_emu_nbid; ++ld_emu_bid)           \
      ld_emu_run((block), [&] { kern(__VA_ARGS__); });                     \
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

// Phase stamps: a timing tool (tools/phase_bench.cu) defines LD_STAMP to
// record clock64() at the numbered phase boundaries of K1, K2, K3 and K5's
// merit stages; in the kernels' own builds a stamp is nothing.
#ifndef LD_STAMP
#define LD_STAMP(i) ((void)0)
#endif

namespace ld {

// Work split inside a block.  On the card a "role" is one thread of its own
// warp and warp_* helpers run on the 32 lanes of one warp; in the host
// build one thread takes every role and every lane, unless a test emulates
// the block's threads.
#ifdef __CUDACC__
LD_DEV bool role(int r) { return (int)threadIdx.x == 32 * r; }
LD_DEV bool in_warp(int w) { return ((int)threadIdx.x >> 5) == w; }
LD_DEV int lane() { return (int)threadIdx.x & 31; }
LD_DEV int lanes() { return 32; }
LD_DEV void warp_sync() { __syncwarp(); }
// rows of an n x n matrix a lane holds in reg_spd_inverse
__host__ __device__ constexpr int rows_per_lane(int n) { return (n + 31) / 32; }
#else
inline bool role(int r) { return ld_emu_ntid == 1 || ld_emu_tid == 32 * r; }
inline bool in_warp(int w) { return ld_emu_ntid == 1 || (ld_emu_tid >> 5) == w; }
inline int lane() { return ld_emu_tid & 31; }
inline int lanes() { return ld_emu_ntid < 32 ? ld_emu_ntid : 32; }
inline void warp_sync() { ld_emu_barrier(ld_emu_tid & ~31, lanes()); }
// one lane may hold every row
constexpr int rows_per_lane(int n) { return n; }
#endif

// A group of lanes of one warp that runs one warp-cooperative routine:
// this lane's index l in the group, the group's size n, and the barrier
// sync(): the group's own, or -- in lockstep -- the whole warp's, so that
// the warp's groups take every step together and run as one instruction
// stream (the routine's control flow must then be the same in each).
// Every lane of the group calls the routine; entry e of an output belongs
// to lane e % n.
struct Lanes {
  int l, n;
#ifdef __CUDACC__
  unsigned mask;
  LD_DEV void sync() const { __syncwarp(mask); }
#else
  int first, count;  // the emulated threads that meet at sync()
  void sync() const { ld_emu_barrier(first, count); }
#endif
};

// The aligned group of `size` lanes (a divisor of 32) this thread is in.
#ifdef __CUDACC__
LD_DEV Lanes group(int size, bool lockstep = false) {
  const int t = (int)threadIdx.x & 31;
  const unsigned m = size == 32 ? 0xffffffffu : ((1u << size) - 1u);
  return Lanes{t & (size - 1), size,
               lockstep ? 0xffffffffu : m << (t & ~(size - 1))};
}
#else
inline Lanes group(int size, bool lockstep = false) {
  if (ld_emu_ntid == 1) return Lanes{0, 1, 0, 1};
  const int l = ld_emu_tid & (size - 1);
  return lockstep ? Lanes{l, size, ld_emu_tid & ~31, lanes()}
                  : Lanes{l, size, ld_emu_tid - l, size};
}
#endif
LD_DEV Lanes warp_lanes() { return group(32); }

// One step of a warp-cooperative routine over entries e < count (count <=
// C): entry e is lane e % N's in a group of N lanes.  Every lane computes
// all its entries (up to 6) first -- the last entry in place of those past
// count -- and only then stores them, so that the latencies of a lane's
// entries overlap; value must not read what store writes.  The host build
// runs the same body: at N under the lane emulation, at 1 on one thread.
template <int N, int C, class V, class S>
LD_FORCE void each_n(const Lanes& g, int count, V&& value, S&& store) {
  constexpr int SN = (C + N - 1) / N;
  if constexpr (SN > 6) {  // a long output: entry after entry
    for (int e = g.l; e < count; e += N) store(e, value(e));
  } else {
    float v[SN];
#pragma unroll
    for (int s = 0; s < SN; ++s) {
      const int e = g.l + N * s;
      v[s] = value(e < count ? e : count - 1);
    }
#pragma unroll
    for (int s = 0; s < SN; ++s)
      if (g.l + N * s < count) store(g.l + N * s, v[s]);
  }
}

// Two outputs of one step, C1 and C2 entries: every lane computes its
// entries of both before it stores any.
template <int N, int C1, int C2, class V1, class S1, class V2, class S2>
LD_FORCE void each2_n(const Lanes& g, V1&& value1, S1&& store1, V2&& value2,
                      S2&& store2) {
  constexpr int SN1 = (C1 + N - 1) / N, SN2 = (C2 + N - 1) / N;
  float v1[SN1], v2[SN2];
#pragma unroll
  for (int s = 0; s < SN1; ++s) {
    const int e = g.l + N * s;
    v1[s] = value1(e < C1 ? e : C1 - 1);
  }
#pragma unroll
  for (int s = 0; s < SN2; ++s) {
    const int e = g.l + N * s;
    v2[s] = value2(e < C2 ? e : C2 - 1);
  }
#pragma unroll
  for (int s = 0; s < SN1; ++s)
    if (g.l + N * s < C1) store1(g.l + N * s, v1[s]);
#pragma unroll
  for (int s = 0; s < SN2; ++s)
    if (g.l + N * s < C2) store2(g.l + N * s, v2[s]);
}

template <int N, int C, class V, class S>
LD_FORCE void each(const Lanes& g, int count, V&& value, S&& store) {
#ifndef __CUDACC__
  if (g.n == 1) return each_n<1, C>(g, count, value, store);
#endif
  each_n<N, C>(g, count, value, store);
}

template <int N, int C, class V, class S>
LD_FORCE void each(const Lanes& g, V&& value, S&& store) {
  each<N, C>(g, C, value, store);
}

template <int N, int C1, int C2, class V1, class S1, class V2, class S2>
LD_FORCE void each2(const Lanes& g, V1&& value1, S1&& store1, V2&& value2,
                    S2&& store2) {
#ifndef __CUDACC__
  if (g.n == 1)
    return each2_n<1, C1, C2>(g, value1, store1, value2, store2);
#endif
  each2_n<N, C1, C2>(g, value1, store1, value2, store2);
}

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
// warp-cooperative dynamics.  Every lane of a group (Lanes, of N lanes on
// the card) calls a routine; the tables, transforms, inputs, outputs and
// the scratch w are in shared memory.  Each output entry belongs to one
// lane, which forms its whole sum in a fixed term order, whatever the
// group's size; the compiler pairs the products into multiply-adds, and in
// a lane that holds more entries of a step it may pair a few otherwise
// (ABA on 8 or 16 lanes parts from 32 lanes in the last place, merit.cuh),
// so the kernels that must agree bit for bit run one group size; each step
// is one instruction stream for the whole group -- which entry a lane holds
// changes the data it reads, not the code it runs -- and a routine ends in
// the group's barrier.
// ---------------------------------------------------------------------------

// entry i of M v and of M' v for a 6x6 M, the terms in k order
LD_FORCE float mv6_at(const float* M, const float* v, int i) {
  float acc = M[6 * i] * v[0];
#pragma unroll
  for (int k = 1; k < 6; ++k) acc += M[6 * i + k] * v[k];
  return acc;
}

LD_FORCE float mtv6_at(const float* M, const float* v, int i) {
  float acc = M[i] * v[0];
#pragma unroll
  for (int k = 1; k < 6; ++k) acc += M[6 * k + i] * v[k];
  return acc;
}

// entry i of cross3(a, b)
LD_FORCE float cross3_at(const float* a, const float* b, int i) {
  const int i1 = i == 2 ? 0 : i + 1, i2 = i == 0 ? 2 : i - 1;
  return a[i1] * b[i2] - a[i2] * b[i1];
}

// entry i of the force cross product (v x*) f: both rows' sums are formed,
// each product used once (so that the compiler pairs each row's products
// into multiply-adds the same way whichever row a lane holds), and selected
LD_FORCE float crf_at(const float* v, const float* f, int i) {
  const int ii = i < 3 ? i : i - 3;
  const float top = cross3_at(v, f, ii) + cross3_at(v + 3, f + 3, ii);
  const float bottom = cross3_at(v, f + 3, ii);
  return i < 3 ? top : bottom;
}

// crm(v) (S w) for S = e_z: entry i is sign(i) v[partner(i)] w, i.e.
// (v1, -v0, 0, v4, -v3, 0) w
LD_FORCE float crz_sign(int i) {
  return i == 2 || i == 5 ? 0.0f : (i == 0 || i == 3 ? 1.0f : -1.0f);
}
LD_FORCE int crz_partner(int i) { return i == 2 || i == 5 ? i : (i < 3 ? 1 - i : 7 - i); }

// a + (crm(v) (S w))[i] as one multiply-add
LD_FORCE float plus_crz(float a, float v_partner, float w, int i) {
  return a + (crz_sign(i) * v_partner) * w;
}

// entry e of dX_j / dq_j = cos(q) Xs - sin(q) Xk
LD_FORCE float dX_at(const float* tab, int j, float s, float c, int e) {
  return c * tab[TAB_XS + 36 * j + e] - s * tab[TAB_XK + 36 * j + e];
}

// entries i of dX_j v and of dX_j' v, dX read in place
LD_FORCE float dmv6_at(const float* tab, int j, float s, float c, const float* v,
                       int i) {
  float acc = dX_at(tab, j, s, c, 6 * i) * v[0];
#pragma unroll
  for (int k = 1; k < 6; ++k) acc += dX_at(tab, j, s, c, 6 * i + k) * v[k];
  return acc;
}

LD_FORCE float dmtv6_at(const float* tab, int j, float s, float c, const float* v,
                        int i) {
  float acc = dX_at(tab, j, s, c, i) * v[0];
#pragma unroll
  for (int k = 1; k < 6; ++k) acc += dX_at(tab, j, s, c, 6 * k + i) * v[k];
  return acc;
}

// Entries e0, e0 + de, ... of the joint transforms X_j (NJ x 36).
LD_DEV void joint_transforms(const float* tab, const float* s, const float* c,
                             float* X, int e0, int de) {
  for (int e = e0; e < NJ * 36; e += de) {
    const int j = e / 36;
    X[e] = tab[TAB_XC + e] + s[j] * tab[TAB_XS + e] + c[j] * tab[TAB_XK + e];
  }
}

template <int N>
LD_FORCE void joint_transforms(const Lanes& g, const float* tab, const float* s,
                               const float* c, float* X) {
  each<N, NJ * 36>(
      g,
      [&](int e) {
        const int j = e / 36;
        return tab[TAB_XC + e] + s[j] * tab[TAB_XS + e] + c[j] * tab[TAB_XK + e];
      },
      [&](int e, float x) { X[e] = x; });
  g.sync();
}

// Articulated-body algorithm (models/dynamics.forward_dynamics): qdd from
// the joint transforms X, qd and the torques u.
constexpr int ABA_FLOATS = 392;

template <int N>
LD_FORCE void aba(const Lanes& g, const float* tab, const float* X,
                  const float* qd, const float* u, float grav, float* qdd,
                  float* w) {
  const float* I = tab + TAB_I;
  float *v = w, *cvel = w + 42, *Iv = w + 84, *pA = w + 126, *IA = w + 168,
        *Ia = w + 204, *AX = w + 240, *pa = w + 276, *Uc = w + 282,
        *dc = w + 324, *uc = w + 331, *an = w + 338, *zero = w + 380;
  each<N, 6>(g, [&](int) { return 0.0f; }, [&](int e, float x) { zero[e] = x; });
  g.sync();
  // velocities outward
  for (int j = 0; j < NJ; ++j) {
    const float* vp = j ? v + 6 * (j - 1) : zero;
    each<N, 6>(
        g,
        [&](int i) {
          const float x = mv6_at(X + 36 * j, vp, i);
          return i == EZ ? x + qd[j] : x;
        },
        [&](int i, float x) { v[6 * j + i] = x; });
    g.sync();
  }
  // cvel = crm_z(v, qd), I v, every joint at once; IA = I_{NJ-1}
  each2<N, 42, 42>(
      g,
      [&](int e) {
        const int j = e / 6, i = e % 6;
        return (crz_sign(i) * v[6 * j + crz_partner(i)]) * qd[j];
      },
      [&](int e, float x) { cvel[e] = x; },
      [&](int e) { return mv6_at(I + 36 * (e / 6), v + 6 * (e / 6), e % 6); },
      [&](int e, float x) { Iv[e] = x; });
  each<N, 36>(g, [&](int e) { return I[36 * (NJ - 1) + e]; },
              [&](int e, float x) { IA[e] = x; });
  g.sync();
  each<N, 42>(g, [&](int e) { return crf_at(v + 6 * (e / 6), Iv + 6 * (e / 6), e % 6); },
              [&](int e, float x) { pA[e] = x; });
  g.sync();
  // articulated inertias inward
  for (int j = NJ - 1; j >= 0; --j) {
    // U = IA[:, z], d, u - pA_z; the rank-1 update Ia = IA - U U' / d
    each2<N, 36, 8>(
        g,
        [&](int e) {
          return IA[e] - IA[6 * (e / 6) + EZ] * IA[6 * (e % 6) + EZ] /
                             IA[6 * EZ + EZ];
        },
        [&](int e, float x) {
          if (j > 0) Ia[e] = x;
        },
        [&](int e) {
          return e < 6 ? IA[6 * e + EZ]
                       : (e == 6 ? IA[6 * EZ + EZ] : u[j] - pA[6 * j + EZ]);
        },
        [&](int e, float x) {
          if (e < 6) Uc[6 * j + e] = x;
          else if (e == 6) dc[j] = x;
          else uc[j] = x;
        });
    g.sync();
    if (j == 0) break;
    const float* Xj = X + 36 * j;
    // Ia X, and pa = pA + Ia cvel + U u / d
    each2<N, 36, 6>(
        g,
        [&](int e) {
          const int r = e / 6, q = e % 6;
          float acc = Ia[6 * r] * Xj[q];
#pragma unroll
          for (int k = 1; k < 6; ++k) acc += Ia[6 * r + k] * Xj[6 * k + q];
          return acc;
        },
        [&](int e, float x) { AX[e] = x; },
        [&](int i) {
          return pA[6 * j + i] + mv6_at(Ia, cvel + 6 * j, i) +
                 Uc[6 * j + i] * (uc[j] / dc[j]);
        },
        [&](int i, float x) { pa[i] = x; });
    g.sync();
    // IA_{j-1} = I_{j-1} + X' Ia X, pA_{j-1} += X' pa
    each2<N, 36, 6>(
        g,
        [&](int e) {
          const int r = e / 6, q = e % 6;
          float acc = Xj[r] * AX[q];
#pragma unroll
          for (int k = 1; k < 6; ++k) acc += Xj[6 * k + r] * AX[6 * k + q];
          return I[36 * (j - 1) + e] + acc;
        },
        [&](int e, float x) { IA[e] = x; },
        [&](int i) { return pA[6 * (j - 1) + i] + mtv6_at(Xj, pa, i); },
        [&](int i, float x) { pA[6 * (j - 1) + i] = x; });
    g.sync();
  }
  // accelerations outward: each lane forms a_{j-1} (and qdd_{j-1}) itself
  for (int j = 0; j <= NJ; ++j) {
    float ap[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, grav}, qp = 0.0f;
    if (j > 0) {
      const float* anp = an + 6 * (j - 1);
      float dot = Uc[6 * (j - 1)] * anp[0];
#pragma unroll
      for (int i = 1; i < 6; ++i) dot += Uc[6 * (j - 1) + i] * anp[i];
      qp = (uc[j - 1] - dot) / dc[j - 1];
#pragma unroll
      for (int i = 0; i < 6; ++i) ap[i] = anp[i];
      ap[EZ] += qp;
    }
    if (j == NJ) {
      if (g.l == 0) qdd[NJ - 1] = qp;
      break;
    }
    each<N, 6>(
        g, [&](int i) { return mv6_at(X + 36 * j, ap, i) + cvel[6 * j + i]; },
        [&](int i, float x) {
          an[6 * j + i] = x;
          if (i == 0 && j > 0) qdd[j - 1] = qp;
        });
    g.sync();
  }
  g.sync();
}

// What the RNEA tangents need of the primal chain: the parent's velocity
// and acceleration at each joint, v, I v, and the backward force
// accumulators facc[j] = f when the backward pass visits j.
struct RneaPrimal {
  float v_in[NJ][6], a_in[NJ][6], v[NJ][6], Iv[NJ][6], facc[NJ][6];
};

// Recursive Newton-Euler for (q, qd, qdd) (qdd null: zero), keeping the
// chain in P; tau[j] = facc[j][z] when tau is not null.
constexpr int RNEA_FLOATS = 138;

template <int N>
LD_FORCE void rnea(const Lanes& g, const float* tab, const float* X,
                   const float* qd, const float* qdd, float grav, RneaPrimal& P,
                   float* tau, float* w) {
  const float* I = tab + TAB_I;
  float *an = w, *Ian = w + 42, *fs = w + 84, *zero = w + 126,
        *gvec = w + 132;
  each<N, 12>(g, [&](int e) { return e == 11 ? grav : 0.0f; },
              [&](int e, float x) { zero[e] = x; });
  g.sync();
  // v and a outward; an a-lane forms the partner entry of v it needs
  for (int j = 0; j < NJ; ++j) {
    const float* Xj = X + 36 * j;
    const float* vp = j ? P.v[j - 1] : zero;
    const float* ap = j ? an + 6 * (j - 1) : gvec;
    const float qdj = qd[j], qddj = qdd ? qdd[j] : 0.0f;
    each2<N, 6, 6>(
        g,
        [&](int i) {
          const float x = mv6_at(Xj, vp, i);
          return i == EZ ? x + qdj : x;
        },
        [&](int i, float x) {
          P.v_in[j][i] = vp[i];
          P.a_in[j][i] = ap[i];
          P.v[j][i] = x;
        },
        [&](int i) {
          const float x = mv6_at(Xj, ap, i);
          return plus_crz(i == EZ ? x + qddj : x, mv6_at(Xj, vp, crz_partner(i)),
                          qdj, i);
        },
        [&](int i, float x) { an[6 * j + i] = x; });
    g.sync();
  }
  // I v and I a, every joint at once; then fs = I a + crf(v) I v
  each2<N, 42, 42>(
      g, [&](int e) { return mv6_at(I + 36 * (e / 6), P.v[e / 6], e % 6); },
      [&](int e, float x) { P.Iv[e / 6][e % 6] = x; },
      [&](int e) { return mv6_at(I + 36 * (e / 6), an + 6 * (e / 6), e % 6); },
      [&](int e, float x) { Ian[e] = x; });
  g.sync();
  each<N, 42>(
      g,
      [&](int e) { return Ian[e] + crf_at(P.v[e / 6], P.Iv[e / 6], e % 6); },
      [&](int e, float x) {
        fs[e] = x;
        if (e >= 36) P.facc[NJ - 1][e - 36] = x;
      });
  g.sync();
  for (int j = NJ - 1; j > 0; --j) {
    each<N, 6>(
        g,
        [&](int i) { return fs[6 * (j - 1) + i] + mtv6_at(X + 36 * j, P.facc[j], i); },
        [&](int i, float x) { P.facc[j - 1][i] = x; });
    g.sync();
  }
  if (tau)
    each<N, NJ>(g, [&](int j) { return P.facc[j][EZ]; },
                [&](int j, float x) { tau[j] = x; });
  g.sync();
}

// The hand-written forward mode of lanedyn.rnea_lane_dtau_units: d tau /
// d(q, qd) at fixed qdd along unit direction d (d < NJ: dq_d, d < 2 NJ:
// dqd_{d-NJ}; larger d: no direction, the lanes only keep step), from the
// primal chain P; dtau[stride * j] for joint j.  It propagates only from its
// seed joint outward, so the directions are independent: K3 runs them on
// 8-lane groups in lockstep, every group taking every joint's steps.
constexpr int DIR_FLOATS = 96;

template <int N>
LD_FORCE void rnea_dtau_direction(const Lanes& g, const float* tab,
                                  const float* X, const float* s, const float* c,
                                  const float* qd, const RneaPrimal& P, int d,
                                  float* dtau, int stride, float* w) {
  const float* I = tab + TAB_I;
  const bool on = d < 2 * NJ, pos = d < NJ;
  const int jd = pos ? d : (on ? d - NJ : NJ);
  // dv, da (two buffers each), Idv, part, the seed's dX' facc, dfs, df
  float *dv = w, *da = w + 12, *Idv = w + 24, *part = w + 30, *sx = w + 36,
        *dfs = w + 42, *df = w + 84;
  const int js = on ? jd : 0;
  const float sd = s[js], cd = c[js];
  // seed: dv = dX v_in, da = dX a_in + crm_z(dv, qd) (dq); dv = e_z,
  // da = crm_z(v, 1) (dqd); and dX' facc for the inward pass (dq)
  for (int i = g.l; i < 6; i += g.n) {
    if (pos) {
      dv[i] = dmv6_at(tab, jd, sd, cd, P.v_in[jd], i);
      da[i] = plus_crz(dmv6_at(tab, jd, sd, cd, P.a_in[jd], i),
                       dmv6_at(tab, jd, sd, cd, P.v_in[jd], crz_partner(i)),
                       qd[jd], i);
      sx[i] = dmtv6_at(tab, jd, sd, cd, P.facc[jd], i);
    } else if (on) {
      dv[i] = i == EZ ? 1.0f : 0.0f;
      da[i] = (crz_sign(i) * P.v[jd][crz_partner(i)]) * 1.0f;
    }
  }
  g.sync();
  // outward from the seed joint: dfs_j = I da + crf(dv) Iv + crf(v) I dv
  for (int j = 0, b = 0; j < NJ; ++j) {
    const bool act = j >= jd;
    const float *v = dv + 6 * b, *a = da + 6 * b;
    for (int i = g.l; i < 6; i += g.n)
      if (act) {
        const float* Ij = I + 36 * j;
        const float x = mv6_at(Ij, v, i);
        const float y = mv6_at(Ij, a, i) + crf_at(v, P.Iv[j], i);
        Idv[i] = x;
        part[i] = y;
      }
    g.sync();
    const int jn = j + 1 < NJ ? j + 1 : j;
    const float* Xn = X + 36 * jn;
    for (int i = g.l; i < 6; i += g.n)
      if (act) {
        const float f = part[i] + crf_at(P.v[j], Idv, i);
        const float x = mv6_at(Xn, v, i);
        const float y = plus_crz(mv6_at(Xn, a, i),
                                 mv6_at(Xn, v, crz_partner(i)), qd[jn], i);
        dfs[6 * j + i] = f;
        if (j + 1 < NJ) {
          dv[6 * (1 - b) + i] = x;
          da[6 * (1 - b) + i] = y;
        }
      }
    if (act) b = 1 - b;
    g.sync();
  }
  // inward: df_{j-1} = dfs_{j-1} + X_j' df_j (+ dX' facc at the seed)
  const float* cur = dfs + 6 * (NJ - 1);
  for (int j = NJ - 1, b = 0; j >= 0; --j) {
    if (on && g.l == 0) dtau[stride * j] = cur[EZ];
    if (j == 0) break;
    float* nxt = df + 6 * b;
    for (int i = g.l; i < 6; i += g.n)
      if (on) {
        float dfn = mtv6_at(X + 36 * j, cur, i);
        dfn = pos && j == jd ? dfn + sx[i] : dfn;
        nxt[i] = j - 1 >= jd ? dfs[6 * (j - 1) + i] + dfn : dfn;
      }
    g.sync();
    cur = nxt;
    b = 1 - b;
  }
  g.sync();
}

// Composite-rigid-body mass matrix M (NJ x NJ, row-major) from the joint
// transforms X.
constexpr int CRBA_FLOATS = 156;

template <int N>
LD_FORCE void crba(const Lanes& g, const float* tab, const float* X, float* M,
                   float* w) {
  const float* I = tab + TAB_I;
  float *Ic = w, *AX = w + 36, *F = w + 72;  // F: two buffers of NJ x 6
  // Ic = I_{NJ-1}; F_{NJ-1} = Ic[:, z]; M's last diagonal entry
  each<N, 36>(g, [&](int e) { return I[36 * (NJ - 1) + e]; },
              [&](int e, float x) {
                Ic[e] = x;
                if (e % 6 == EZ) F[6 * (NJ - 1) + e / 6] = x;
                if (e == 7 * EZ) M[NJ * NJ - 1] = x;
              });
  g.sync();
  // composite inertias inward: F_{j-1} = Ic_{j-1}[:, z], M_{j-1,j-1}
  for (int j = NJ - 1; j > 0; --j) {
    const float* Xj = X + 36 * j;
    each<N, 36>(
        g,
        [&](int e) {
          const int r = e / 6, q = e % 6;
          float acc = Ic[6 * r] * Xj[q];
#pragma unroll
          for (int k = 1; k < 6; ++k) acc += Ic[6 * r + k] * Xj[6 * k + q];
          return acc;
        },
        [&](int e, float x) { AX[e] = x; });
    g.sync();
    each<N, 36>(
        g,
        [&](int e) {
          const int r = e / 6, q = e % 6;
          float acc = Xj[r] * AX[q];
#pragma unroll
          for (int k = 1; k < 6; ++k) acc += Xj[6 * k + r] * AX[6 * k + q];
          return I[36 * (j - 1) + e] + acc;
        },
        [&](int e, float x) {
          Ic[e] = x;
          if (e % 6 == EZ) F[6 * (j - 1) + e / 6] = x;
          if (e == 7 * EZ) M[(NJ + 1) * (j - 1)] = x;
        });
    g.sync();
  }
  // F_i <- X_j' F_i for i >= j, j = NJ-1 .. 1, into the other buffer (row
  // j-1 comes from the first, where no pass has touched it)
  float *Fc = F, *Fn = F + 42;
  for (int j = NJ - 1; j > 0; --j) {
    const float* Xj = X + 36 * j;
    each<N, 42>(
        g, 6 * (NJ - j + 1),
        [&](int e) {
          const int i = j - 1 + e / 6, r = e % 6;
          return i == j - 1 ? F[6 * i + r] : mtv6_at(Xj, Fc + 6 * i, r);
        },
        [&](int e, float x) {
          const int i = j - 1 + e / 6, r = e % 6;
          Fn[6 * i + r] = x;
          if (r == EZ && i != j - 1) {
            M[NJ * i + (j - 1)] = x;
            M[NJ * (j - 1) + i] = x;
          }
        });
    g.sync();
    float* sw = Fc;
    Fc = Fn;
    Fn = sw;
  }
}

// End-effector xyz and, when J is not null, its position Jacobian J
// (3 x NJ, row-major): column j = (H_0..H_{j-1} dH_j H_{j+1}..H_{NJ-1})[:3, 3].
// The prefix products P_j = H_0..H_{j-1} and the suffix columns
// sv_j = (H_j..H_{NJ-1})[:, 3] run as two chains at once.
constexpr int FK_FLOATS = 412;

template <int N>
LD_FORCE void fk_ee_jac(const Lanes& g, const float* tab, const float* s,
                        const float* c, float* ee, float* J, float* w) {
  float *H = w, *dH = w + 112, *Pp = w + 224, *sv = w + 352, *wv = w + 384;
  // H_j and dH_j; P_0 = identity; sv_NJ = (0, 0, 0, 1)
  each<N, 244>(
      g, J ? 244 : 112,
      [&](int e) {
        const int base = e < 112 ? TAB_HC : TAB_DHC, f = e % 112, j = f / 16;
        const int q = f % 16;
        return tab[base + 16 * j + q] + s[j] * tab[base + NJ * 16 + 16 * j + q] +
               c[j] * tab[base + 2 * NJ * 16 + 16 * j + q];
      },
      [&](int e, float x) { H[e] = x; });
  each<N, 20>(g, [&](int e) { return e < 16 ? (e % 5 == 0 ? 1.0f : 0.0f) : (e == 19 ? 1.0f : 0.0f); },
              [&](int e, float x) { (e < 16 ? Pp : sv + 4 * NJ - 16)[e] = x; });
  g.sync();
  // P_{t+1} = P_t H_t and sv_{NJ-1-t} = H_{NJ-1-t} sv_{NJ-t}, t = 0 .. NJ-1
  for (int t = 0; t < NJ; ++t) {
    const int j = NJ - 1 - t;
    each2<N, 16, 4>(
        g,
        [&](int e) {
          const float *A = Pp + 16 * t + 4 * (e / 4), *B = H + 16 * t + e % 4;
          float acc = A[0] * B[0];
#pragma unroll
          for (int k = 1; k < 4; ++k) acc += A[k] * B[4 * k];
          return acc;
        },
        [&](int e, float x) { Pp[16 * (t + 1) + e] = x; },
        [&](int i) {
          const float *A = H + 16 * j + 4 * i, *B = sv + 4 * (j + 1);
          float acc = A[0] * B[0];
#pragma unroll
          for (int k = 1; k < 4; ++k) acc += A[k] * B[k];
          return acc;
        },
        [&](int i, float x) { sv[4 * j + i] = x; });
    g.sync();
  }
  if (J) {
    each<N, 4 * NJ>(
        g,
        [&](int e) {
          const int j = e / 4, i = e % 4;
          const float *d = dH + 16 * j, *sn = sv + 4 * (j + 1);
          float acc = d[4 * i] * sn[0];
#pragma unroll
          for (int k = 1; k < 4; ++k) acc += d[4 * i + k] * sn[k];
          return acc;
        },
        [&](int e, float x) { wv[e] = x; });
    g.sync();
  }
  each<N, 3 + 3 * NJ>(
      g, J ? 3 + 3 * NJ : 3,
      [&](int e) {
        if (e < 3) return Pp[16 * NJ + 4 * e + 3];
        const int f = e - 3, r = f / NJ, j = f % NJ;
        const float *P = Pp + 16 * j, *wj = wv + 4 * j;
        float acc = P[4 * r] * wj[0];
#pragma unroll
        for (int k = 1; k < 4; ++k) acc += P[4 * r + k] * wj[k];
        return acc;
      },
      [&](int e, float x) { (e < 3 ? ee : J - 3)[e] = x; });
  g.sync();
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

// In-place inverse of an SPD n x n matrix A (shared memory, row-major) by
// the same Gauss-Jordan steps, each row in the registers of one lane
// (rows_per_lane(n) rows a lane: one on the card, n <= 32).  Per pivot its
// row goes through the warp's shared buffer buf (2 n floats): the row's
// lane writes it, lane j divides entry j, and every lane reads the
// normalized row back and updates its own -- two divisions a lane and two
// warp barriers a pivot, no load-store chain per entry.  (Shuffles would
// do the same, but in code under a warp-dependent branch the compiler
// wraps each in a convergence loop.)  Bit-equal to warp_spd_inverse.
// Every lane of the warp must call it.
template <int n>
LD_DEV void reg_spd_inverse(float* A, float* buf) {
  constexpr int R = rows_per_lane(n);
  const int l = lane(), nl = lanes();
  float *raw = buf, *nrm = buf + n;
  float a[R][n];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = l + nl * r;
#pragma unroll
    for (int j = 0; j < n; ++j) a[r][j] = i < n ? A[n * i + j] : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const int ow = k % nl, sk = k / nl;
    if (l == ow)
#pragma unroll
      for (int j = 0; j < n; ++j) raw[j] = a[sk][j];
    warp_sync();
    const float piv = raw[k];
    for (int j = l; j < n; j += nl) nrm[j] = j == k ? 1.0f / piv : raw[j] / piv;
    warp_sync();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = l + nl * r;
      if (i == k) {
#pragma unroll
        for (int j = 0; j < n; ++j) a[r][j] = nrm[j];
      } else if (i < n) {
        const float f = a[r][k];
#pragma unroll
        for (int j = 0; j < n; ++j)
          if (j != k) a[r][j] -= f * nrm[j];
        a[r][k] = -f / piv;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = l + nl * r;
    if (i < n)
#pragma unroll
      for (int j = 0; j < n; ++j) A[n * i + j] = a[r][j];
  }
  warp_sync();
}

}  // namespace ld
