// K2: line-search merits, one launch for all step sizes.
//
// Replaces the TPU kernel mpcgpu_tpu/ops/pallas/merit_kernel.py
// (line_search_merits_pallas / _merit_kernel).  Candidate a is
// (X + alpha_a dX, U + alpha_a dU) with alpha_a = 1/2^a for a < num_alphas
// and alpha = 0 (the unstepped point) for the last:
//
//   merit = sum_k J_k + mu * (sum_{k<N-1} ||x_{k+1} - f(x_k, u_k)||_1
//                              + ||x_0 - xs||_1)
//
// with the eepos tracking cost J_k and explicit-Euler ABA dynamics f.
//
// Bound on the H100: the latency of one knot's FK + ABA chain.  Each
// (candidate, knot) pair is one group of G lanes (merit.cuh's
// merit_contrib, the warp-cooperative recursions of lanedyn.cuh), 128/G
// groups a block and as many blocks as the pairs need, so the pairs run at
// once over many SMs.  G = 32 up to 2304 pairs (N <= 256 at 8 step sizes),
// whose merits equal, bit for bit, those of a one-thread FK + ABA chain
// per pair (merit.cuh); past it G = 8, a quarter of the blocks (128
// registers a thread hold 4 blocks an SM, and 32-lane groups would take
// more than two waves).  Each group writes its contribution to global
// memory; the last block to finish (an integer count, reset by that block
// for the next launch) sums each candidate's N contributions in knot
// order.  The order of every sum is fixed, so the merits are the same from
// run to run.
#include "merit.cuh"

#ifdef __CUDACC__
#define K2_FENCE() __threadfence()
#define K2_COUNT(p) atomicAdd((p), 1u)
#define K2_LOAD(p) __ldcg(p)
#else
#define K2_FENCE() ((void)0)
#define K2_COUNT(p) ((*(p))++)
#define K2_LOAD(p) (*(p))
#endif

namespace {

constexpr int K2_THREADS = 128;

template <int G>
LD_GLOBAL void LD_LAUNCH_BOUNDS(K2_THREADS) merit_kernel(
    const float* __restrict__ tab_g, const float* X, const float* U,
    const float* dX, const float* dU, const float* goals, int gstride,
    const float* xs, int N, int num_alphas, float dt, float mu, float qd_cost,
    float r_cost, float grav, float* contrib, unsigned* done, float* out) {
  LD_SHARED float tab[ld::TAB_SIZE];
  LD_SHARED int last;
  LD_DYN_SMEM(smem);
  ld::load_tables(tab, tab_g);
  const k2::Job job{X, dX, U, dU, goals, xs, contrib, N, 1, num_alphas + 1,
                    num_alphas, gstride, 0, 0, dt, mu, qd_cost, r_cost, grav};
  k2::contribs<G>(tab, smem, job);
  // the last block to finish sums the contributions
  K2_FENCE();
  LD_SYNC();
  if (LD_TID == 0) last = K2_COUNT(done) == (unsigned)LD_NBID - 1u;
  LD_SYNC();
  if (!last) return;
  K2_FENCE();
  for (int a = LD_TID; a <= num_alphas; a += LD_NTID) {
    float acc = 0.0f;
    for (int k = 0; k < N; ++k) acc += K2_LOAD(contrib + N * a + k);
    out[a] = acc;
  }
  if (LD_TID == 0) *done = 0u;
}

// The group size K2 takes for `pairs` (candidate, knot) pairs.
int k2_group(int pairs) { return pairs <= 2304 ? 32 : 8; }

template <int G>
int launch(const float* tab, const float* X, const float* U, const float* dX,
           const float* dU, const float* goals, int gstride, const float* xs,
           int N, int num_alphas, float dt, float mu, float qd_cost,
           float r_cost, float grav, float* contrib, unsigned* done,
           float* out, void* stream) {
  const int pairs = (num_alphas + 1) * N, per_block = K2_THREADS / G;
  const int blocks = (pairs + per_block - 1) / per_block;
  const size_t smem = sizeof(float) * k2::areas_floats(K2_THREADS, G);
#ifdef __CUDACC__
  // past 48 KB only after opting in
  cudaError_t err = cudaFuncSetAttribute(
      merit_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
#endif
  LD_LAUNCH(merit_kernel<G>, blocks, K2_THREADS, smem, stream, tab, X, U, dX,
            dU, goals, gstride, xs, N, num_alphas, dt, mu, qd_cost, r_cost,
            grav, contrib, done, out);
  return LD_LAST_ERROR();
}

}  // namespace

// contrib: (num_alphas + 1) N floats of scratch; done: one unsigned count,
// zero before the first launch (each launch leaves it zero).  group: the
// lanes of a pair's group (8, 16 or 32), 0 for K2's own choice.
extern "C" int mpc_merits(const float* tab, const float* X, const float* U,
                          const float* dX, const float* dU,
                          const float* goals, int gstride, const float* xs,
                          int N, int num_alphas, float dt, float mu,
                          float qd_cost, float r_cost, float grav,
                          float* contrib, unsigned* done, int group,
                          float* out, void* stream) {
  if (N < 2 || num_alphas < 0) return 1;  // cudaErrorInvalidValue
  const int G = group ? group : k2_group((num_alphas + 1) * N);
  auto go = [&](auto launcher) {
    return launcher(tab, X, U, dX, dU, goals, gstride, xs, N, num_alphas, dt,
                    mu, qd_cost, r_cost, grav, contrib, done, out, stream);
  };
  if (G == 32) return go(launch<32>);
  if (G == 16) return go(launch<16>);
  if (G == 8) return go(launch<8>);
  return 1;
}

#ifndef __CUDACC__
// Host build only: knot k's contribution at alpha (no step when dX and dU
// are null) on the groups of `group` lanes of one warp, every group the
// same pair, group i's to out[i] (out[0] alone on one thread), so that a
// test holds it against the plain contribution at one lane and, with the
// block's threads emulated (mpc_emu_threads_host), at 32 lanes.
namespace {

template <int G>
LD_GLOBAL void k2_pair_kernel(const float* tab_g, const float* X,
                              const float* U, const float* dX,
                              const float* dU, const float* goals, int gstride,
                              const float* xs, int N, int k, float alpha,
                              float dt, float mu, float qd_cost, float r_cost,
                              float grav, float* out) {
  LD_SHARED float tab[ld::TAB_SIZE], areas[32 / G * k2::AREA_FLOATS];
  ld::load_tables(tab, tab_g);
  const int l = LD_NTID >= G ? LD_TID / G : 0;
  const float v = k2::merit_contrib<G>(
      ld::group(G, true), tab, areas + k2::AREA_FLOATS * l, X, dX, U, dU, k,
      N, alpha, goals + gstride * k, xs, dt, mu, qd_cost, r_cost, grav);
  if (LD_TID % G == 0) out[l] = v;
}

}  // namespace

extern "C" int mpc_k2_contrib_host(const float* tab, const float* X,
                                   const float* U, const float* dX,
                                   const float* dU, const float* goals,
                                   int gstride, const float* xs, int N, int k,
                                   float alpha, float dt, float mu,
                                   float qd_cost, float r_cost, float grav,
                                   int group, float* out) {
  if (group == 32)
    LD_LAUNCH(k2_pair_kernel<32>, 1, 32, 0, nullptr, tab, X, U, dX, dU, goals,
              gstride, xs, N, k, alpha, dt, mu, qd_cost, r_cost, grav, out);
  else if (group == 16)
    LD_LAUNCH(k2_pair_kernel<16>, 1, 32, 0, nullptr, tab, X, U, dX, dU, goals,
              gstride, xs, N, k, alpha, dt, mu, qd_cost, r_cost, grav, out);
  else if (group == 8)
    LD_LAUNCH(k2_pair_kernel<8>, 1, 32, 0, nullptr, tab, X, U, dX, dU, goals,
              gstride, xs, N, k, alpha, dt, mu, qd_cost, r_cost, grav, out);
  else
    return 1;
  return 0;
}
#endif
