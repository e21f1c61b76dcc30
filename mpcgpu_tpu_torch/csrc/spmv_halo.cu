// K11: the block-tridiagonal product over one knot shard, with the
// neighbouring shards' edge rows as halos:
//   y_k = L_k x_{k-1} + D_k x_k + U_k x_{k+1},   k = 0 .. nl-1,
// where x_{-1} is xl (the left neighbour's last row) and x_{nl} is xr (the
// right neighbour's first row), both zero at the global edges.
//
// Replaces the TPU kernel mpcgpu_tpu/parallel/pcg_sharded_pallas.py
// (_spmv_halo_pallas / _spmv_halo_kernel), the SpMV that the horizon-sharded
// CG runs twice per step on each shard (S p and Pinv r).  The TPU version
// takes its bands pre-transposed to (j, i, nl) and builds x_{k+-1} with a
// lane roll and a mask; here everything is knot-major, as the rest of the
// port: bands (nl, 14, 14) row-major, x and y (nl, 14), halos (14,).
//
// Bound on the H100: latency.  At nl = 64 the call moves ~158 KB (three
// bands and four vectors), about 0.05 us at 3.35 TB/s, and does ~0.07
// MFLOP; the launch costs more than either.  So the kernel is the simple
// form: one thread per output row (k, i), reading its three band rows
// (42 contiguous floats) and the three neighbouring x rows, summing in the
// TPU kernel's order (the D row, then L and U interleaved by column).
// Blocks of 128 threads stride over the rows, so any nl launches.
#include "lanedyn.cuh"

namespace {

constexpr int S = ld::NX;
constexpr int THREADS = 128;

LD_GLOBAL void spmv_halo_kernel(int nl, const float* __restrict__ L,
                                const float* __restrict__ D,
                                const float* __restrict__ U,
                                const float* __restrict__ x,
                                const float* __restrict__ xl,
                                const float* __restrict__ xr,
                                float* __restrict__ y) {
  const int rows = nl * S;
  for (int e = LD_BID * LD_NTID + LD_TID; e < rows; e += LD_NBID * LD_NTID) {
    const int k = e / S;
    const float* xm = k > 0 ? x + (size_t)(k - 1) * S : xl;
    const float* xk = x + (size_t)k * S;
    const float* xp = k < nl - 1 ? x + (size_t)(k + 1) * S : xr;
    const float* Lr = L + (size_t)e * S;
    const float* Dr = D + (size_t)e * S;
    const float* Ur = U + (size_t)e * S;
    float acc = Dr[0] * xk[0];
#pragma unroll
    for (int j = 1; j < S; ++j) acc += Dr[j] * xk[j];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      acc += Lr[j] * xm[j];
      acc += Ur[j] * xp[j];
    }
    y[e] = acc;
  }
}

}  // namespace

extern "C" int mpc_spmv_halo(int nl, const float* L, const float* D,
                             const float* U, const float* x, const float* xl,
                             const float* xr, float* y, void* stream) {
  if (nl < 1) return 1;  // cudaErrorInvalidValue
  const int blocks = (nl * S + THREADS - 1) / THREADS;
  LD_LAUNCH(spmv_halo_kernel, blocks, THREADS, 0, stream, nl, L, D, U, x, xl,
            xr, y);
  return LD_LAST_ERROR();
}
