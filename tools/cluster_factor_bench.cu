// Times the block cyclic reduction's parts (csrc/bcr_common.cuh) on the card,
// CUDA events over 20 launches after 3 warm-up launches, at each N given on
// the command line (powers of 2; default 64 128 256 1024):
//   - the cluster factor (K6's and K7s's) over one cluster of 16 blocks of
//     512 threads: whole, ten passes of level 0's warp inverses in the
//     shared-memory Gauss-Jordan (warp_spd_inverse) and in registers
//     (reg_spd_inverse, bit-equal), ten of level 0's products and kept-knot
//     updates, ten cluster barriers, the set-up alone, and the factor with
//     ten cluster applies after it (an apply: the difference over ten);
//   - the one-block factor (bcr_factor, threads_for(N) threads, S read from
//     global memory) alone and with one apply (BcrPre): K7s's body before
//     it became a cluster kernel;
//   - the refined solve and dz of K9b's stage 4 on 128-thread blocks: in one
//     block (bcr_dz_body, S from global memory, where its vectors fit one
//     block), and across one cluster of 16 (cluster_bcr_dz; built with
//     -DNO_CLUSTER_BCR_DZ, against a tree whose header lacks it, the bench
//     leaves this out).
// The bands are a fixed well-conditioned system; every launch refactors it.
//
//   mkdir -p build && nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/cluster_factor_bench tools/cluster_factor_bench.cu && \
//     build/cluster_factor_bench 64 128 256 1024
#include "../mpcgpu_tpu_torch/csrc/bcr_common.cuh"
#include <cstdio>
#include <cstdlib>
#include <vector>
#include <cmath>
constexpr int S = 14, SS = 196, C = 16, ITER_THREADS = 128;

// a level's inverses, warp gw of nw, in the shared-memory Gauss-Jordan
// (reg false) or with a row a lane in registers (reg true)
__device__ void level_inverses(const bcr::BcrFactor& f, int first, int step,
                               int gw, int nw, float* A, float* buf,
                               bool reg) {
  for (int j = first + gw * step; j < f.N; j += nw * step) {
    for (int e = ld::lane(); e < SS; e += 32) A[e] = f.D[SS * j + e];
    ld::warp_sync();
    if (reg) ld::reg_spd_inverse<S>(A, buf);
    else ld::warp_spd_inverse<S>(A);
    for (int e = ld::lane(); e < SS; e += 32) f.Dinv[SS * j + e] = A[e];
    ld::warp_sync();
  }
}

__global__ void __launch_bounds__(512) k_factor(int N, int lv, const float* SL, const float* SD, const float* SU, float* fac, int mode) {
  extern __shared__ float smem[];
  const pcgc::ClusterCg a = pcgc::cluster_area(smem, N, false);
  pcgc::cluster_load_bands(a, SL, SD, SU, a.SL, a.SD, a.SU);
  const bcr::BcrFactor f(fac, N, lv);
  if (mode == 0 || mode == 6) {
    bcr::cluster_factor(f, a, a.extra);
    if (mode == 6) {
      for (int e = threadIdx.x; e < S * a.own; e += blockDim.x) a.r[0][S + e] = SD[S * a.k0 + e];
      for (int rep = 0; rep < 10; ++rep) { bcr::ClusterBcr{f}.apply(a, a.r[0], a.z); LD_CLUSTER_SYNC(); }
    }
    return;
  }
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int gw = a.rank * warps + warp, nw = a.C * warps;
  float* A = a.extra + 2 * SS * warp; float* B = A + SS;
  for (int e = threadIdx.x; e < SS * a.own; e += blockDim.x) {
    f.D[SS * a.k0 + e] = a.SD[e]; f.L[SS * a.k0 + e] = a.SL[e]; f.U[SS * a.k0 + e] = a.SU[e];
  }
  LD_CLUSTER_SYNC();
  for (int rep = 0; rep < 10; ++rep) {
    if (mode == 1) level_inverses(f, 1, 2, gw, nw, A, B, false);
    if (mode == 2) bcr::spread_level(f, 0, gw, nw, A, B);
    if (mode == 3) { LD_CLUSTER_SYNC(); }
    if (mode == 5) level_inverses(f, 1, 2, gw, nw, A, B, true);
  }
  LD_CLUSTER_SYNC();
}

// the one-block factor, alone (mode 0) or with one apply (mode 1)
__global__ void __launch_bounds__(512) k_one(int N, int lv, const float* SL, const float* SD, const float* SU, float* fac, float* out, int mode) {
  extern __shared__ float smem[];
  float* g = smem;
  float* z = g + S * N;
  float* inv = z + S * N;
  const bcr::BcrFactor f(fac, N, lv);
  bcr::bcr_factor(f, SL, SD, SU, inv);
  if (mode == 1) {
    bcr::BcrPre{f, g}.apply(SD, z);
    for (int e = threadIdx.x; e < S * N; e += blockDim.x) out[e] = z[e];
  }
}

// K9b's stage 4 in one block (bcr_dz_body); dz inputs are zeros
__global__ void k_refined_one(int N, const float* SL, const float* SD, const float* SU, const float* zeros, float* fac, float* lam, float* dX, float* dU) {
  extern __shared__ float smem[];
  bcr::bcr_dz_body(N, SL, SD, SU, SD, zeros, zeros, zeros, zeros, zeros, zeros, fac, smem, lam, dX, dU);
}

#ifndef NO_CLUSTER_BCR_DZ
// K9b's stage 4 across one cluster (cluster_bcr_dz)
__global__ void k_refined_cluster(int N, int lv, const float* SL, const float* SD, const float* SU, const float* zeros, float* fac, float* lam, float* dX, float* dU) {
  extern __shared__ float smem[];
  const pcgc::ClusterCg a = pcgc::cluster_area(smem, N, false);
  pcgc::cluster_load_bands(a, SL, SD, SU, a.SL, a.SD, a.SU);
  bcr::cluster_bcr_dz(a, bcr::BcrFactor(fac, N, lv), SD, zeros, zeros, zeros, zeros, zeros, zeros, lam, dX, dU);
}
#endif

template <class Launch>
void timed(int N, const char* name, Launch launch) {
  for (int w = 0; w < 3; ++w) launch();
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  cudaEventRecord(a);
  for (int r = 0; r < 20; ++r) launch();
  cudaEventRecord(b); cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b);
  printf("N=%d %s: %.2f us per launch (err %d)\n", N, name, 1e3 * ms / 20, (int)cudaGetLastError());
}

cudaLaunchConfig_t cluster_cfg(int threads, size_t smem, cudaLaunchAttribute* at) {
  cudaLaunchConfig_t cfg = {}; cfg.gridDim = dim3(C); cfg.blockDim = dim3(threads); cfg.dynamicSmemBytes = smem;
  at[0].id = cudaLaunchAttributeClusterDimension; at[0].val.clusterDim.x = C; at[0].val.clusterDim.y = 1; at[0].val.clusterDim.z = 1;
  cfg.attrs = at; cfg.numAttrs = 1;
  return cfg;
}

int main(int argc, char** argv) {
  std::vector<int> knots;
  for (int i = 1; i < argc; ++i) knots.push_back(std::atoi(argv[i]));
  if (knots.empty()) knots = {64, 128, 256, 1024};
  int optin = 0;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, 0);
  for (int N : knots) {
    int lv = 0; while ((1 << lv) < N) ++lv;
    std::vector<float> h(3 * N * SS, 0.f);
    for (int k = 0; k < N; ++k) for (int i = 0; i < S; ++i) for (int j = 0; j < S; ++j) {
      h[SS * k + S * i + j] = (i == j) ? 0.0f : 0.0f;              // L
      h[N * SS + SS * k + S * i + j] = (i == j) ? 20.0f : 0.1f / (1 + i + j);  // D
      h[2 * N * SS + SS * k + S * i + j] = 0.05f * std::sin(i + 2 * j + k);   // U
    }
    for (int k = 1; k < N; ++k) for (int i = 0; i < S; ++i) for (int j = 0; j < S; ++j)
      h[SS * k + S * i + j] = h[2 * N * SS + SS * (k - 1) + S * j + i];  // L_k = U_{k-1}^T
    float *d, *fac, *zeros, *lam, *dX, *dU;
    cudaMalloc(&d, h.size() * 4); cudaMemcpy(d, h.data(), h.size() * 4, cudaMemcpyHostToDevice);
    cudaMalloc(&fac, bcr::factor_floats(N) * 4);
    cudaMalloc(&zeros, (size_t)N * SS * 4); cudaMemset(zeros, 0, (size_t)N * SS * 4);
    cudaMalloc(&lam, (size_t)N * S * 4); cudaMalloc(&dX, (size_t)N * S * 4); cudaMalloc(&dU, (size_t)N * S * 4);
    const float *SL = d, *SD = d + N * SS, *SU = d + 2 * N * SS;
    cudaLaunchAttribute at[1];
    size_t smem = pcgc::cluster_cg_floats(N, C, false, bcr::SCRATCH_FLOATS) * 4;
    cudaFuncSetAttribute(k_factor, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaFuncSetAttribute(k_factor, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaLaunchConfig_t cfg = cluster_cfg(512, smem, at);
    const char* names[] = {"cluster factor, whole", "cluster: 10 x level-0 inverses (shared memory)",
                           "cluster: 10 x level-0 products+update", "cluster: 10 x cluster.sync",
                           "cluster: setup only", "cluster: 10 x level-0 inverses (registers)",
                           "cluster factor + 10 applies"};
    for (int mode = 0; mode < 7; ++mode)
      timed(N, names[mode], [&] { cudaLaunchKernelEx(&cfg, k_factor, N, lv, SL, SD, SU, fac, mode); });
    const int t1 = bcr::threads_for(N);
    // g, z and bcr_factor's inverse scratch: dz_vec_floats less two vectors
    const size_t s1 = (bcr::dz_vec_floats(N) - (size_t)2 * N * S) * 4;
    cudaFuncSetAttribute(k_one, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
    timed(N, "one block: factor", [&] { k_one<<<1, t1, s1>>>(N, lv, SL, SD, SU, fac, lam, 0); });
    timed(N, "one block: factor + apply (K7s before)", [&] { k_one<<<1, t1, s1>>>(N, lv, SL, SD, SU, fac, lam, 1); });
    const size_t s9 = bcr::dz_vec_floats(N) * 4;
    if (s9 <= (size_t)optin) {
      cudaFuncSetAttribute(k_refined_one, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s9);
      timed(N, "refined + dz, one block of 128 (K9b's stage 4 before)", [&] {
        k_refined_one<<<1, ITER_THREADS, s9>>>(N, SL, SD, SU, zeros, fac, lam, dX, dU); });
    }
#ifndef NO_CLUSTER_BCR_DZ
    const size_t sc = pcgc::cluster_cg_floats(N, C, false, bcr::scratch_floats(ITER_THREADS)) * 4;
    if (sc <= (size_t)optin) {
      cudaFuncSetAttribute(k_refined_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      cudaFuncSetAttribute(k_refined_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sc);
      cudaLaunchAttribute atc[1];
      cudaLaunchConfig_t cfgc = cluster_cfg(ITER_THREADS, sc, atc);
      timed(N, "refined + dz, one cluster of 16 x 128 (K9b's stage 4)", [&] {
        cudaLaunchKernelEx(&cfgc, k_refined_cluster, N, lv, SL, SD, SU, (const float*)zeros, fac, lam, dX, dU); });
    }
#endif
    cudaFree(d); cudaFree(fac); cudaFree(zeros); cudaFree(lam); cudaFree(dX); cudaFree(dU);
  }
}
