// K11: the block-tridiagonal product over the consecutive knot shards one
// process holds, in one launch:
//   y_k = L_k x_{k-1} + D_k x_k + U_k x_{k+1},   k = 0 .. nl-1 of each shard,
// where a shard's x_{-1} is the previous shard's last row and its x_{nl} the
// next shard's first row; outside the shards the launch holds, xl (the
// left neighbour's last row) and xr (the right neighbour's first row), both
// zero at the global edges.
//
// Replaces the TPU kernel mpcgpu_tpu/parallel/pcg_sharded_pallas.py
// (_spmv_halo_pallas / _spmv_halo_kernel), the SpMV that the horizon-sharded
// CG runs twice per step on each shard (S p and Pinv r).  The TPU version
// takes its bands pre-transposed to (j, i, nl) and builds x_{k+-1} with a
// lane roll and a mask; here everything is knot-major, as the rest of the
// port: bands (nl, 14, 14) row-major, x and y (nl, 14), halos (14,).
//
// Bound on the H100: latency.  A shard of nl = 64 knots moves ~158 KB
// (three bands and four vectors), about 0.05 us at 3.35 TB/s, and does
// ~0.07 MFLOP; a launch costs about 2 us.  So one launch covers every shard
// of the process (of an in-process mesh, the whole horizon), and the rows
// at a shard's edge read the neighbouring shard's x row where it lies:
// only the two rows outside the process come from the mesh's collective.
// The shards' pointers pass by value in the kernel's parameters (Shards,
// read in place through __grid_constant__), so a launch needs no pointer
// table in device memory; past MAX_SHARDS shards the entry launches once
// per group.  One thread per output row (s, k, i) reads its three band
// rows (42 contiguous floats) and the three neighbouring x rows and sums
// in the TPU kernel's order (the D row, then L and U interleaved by
// column), so each shard's y equals a launch over that shard alone bit for
// bit.  Blocks of 128 threads stride over the rows, so any count launches.
#include "lanedyn.cuh"

namespace {

constexpr int S = ld::NX;
constexpr int THREADS = 128;
// shards per launch: 5 pointers a shard, 2.6 KB of the 4 KB of kernel
// parameters
constexpr int MAX_SHARDS = 64;

struct Shards {
  const float* L[MAX_SHARDS];
  const float* D[MAX_SHARDS];
  const float* U[MAX_SHARDS];
  const float* x[MAX_SHARDS];
  float* y[MAX_SHARDS];
  const float* xl;   // x_{-1} of shard 0
  const float* xr;   // x_{nl} of the last shard
  int n, nl;         // shards, knots a shard
};

#ifdef __CUDACC__
#define K11_SHARDS const __grid_constant__ Shards
#else
#define K11_SHARDS const Shards&
#endif

LD_GLOBAL void spmv_halo_kernel(K11_SHARDS p) {
  const int nl = p.nl, rows = nl * S;
  for (int e = LD_BID * LD_NTID + LD_TID; e < p.n * rows;
       e += LD_NBID * LD_NTID) {
    const int s = e / rows, er = e - s * rows, k = er / S;
    const float* x = p.x[s];
    const float* xm = k > 0 ? x + (size_t)(k - 1) * S
                      : s > 0 ? p.x[s - 1] + (size_t)(nl - 1) * S
                      : p.xl;
    const float* xk = x + (size_t)k * S;
    const float* xp = k < nl - 1 ? x + (size_t)(k + 1) * S
                      : s < p.n - 1 ? p.x[s + 1]
                      : p.xr;
    const float* Lr = p.L[s] + (size_t)er * S;
    const float* Dr = p.D[s] + (size_t)er * S;
    const float* Ur = p.U[s] + (size_t)er * S;
    float acc = Dr[0] * xk[0];
#pragma unroll
    for (int j = 1; j < S; ++j) acc += Dr[j] * xk[j];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      acc += Lr[j] * xm[j];
      acc += Ur[j] * xp[j];
    }
    p.y[s][er] = acc;
  }
}

}  // namespace

// Shards one launch of K11 covers.
extern "C" int mpc_spmv_halo_max_shards(void) { return MAX_SHARDS; }

// K11 over n consecutive shards of nl knots: L, D, U, x and y are host
// arrays of the shards' n device pointers ((nl, 14, 14) bands, (nl, 14)
// vectors), xl and xr the rows outside them.  One launch per MAX_SHARDS
// shards, a group's outer rows its neighbour groups' edge rows.
extern "C" int mpc_spmv_halo(int n, int nl, const float* const* L,
                             const float* const* D, const float* const* U,
                             const float* const* x, float* const* y,
                             const float* xl, const float* xr, void* stream) {
  if (n < 1 || nl < 1) return 1;  // cudaErrorInvalidValue
  for (int g = 0; g < n; g += MAX_SHARDS) {
    Shards p = {};
    p.n = n - g < MAX_SHARDS ? n - g : MAX_SHARDS;
    p.nl = nl;
    for (int i = 0; i < p.n; ++i) {
      p.L[i] = L[g + i];
      p.D[i] = D[g + i];
      p.U[i] = U[g + i];
      p.x[i] = x[g + i];
      p.y[i] = y[g + i];
    }
    p.xl = g > 0 ? x[g - 1] + (size_t)(nl - 1) * S : xl;
    p.xr = g + p.n < n ? x[g + p.n] : xr;
    const int blocks = (p.n * nl * S + THREADS - 1) / THREADS;
    LD_LAUNCH(spmv_halo_kernel, blocks, THREADS, 0, stream, p);
    const int err = LD_LAST_ERROR();
    if (err != 0) return err;
  }
  return 0;
}
