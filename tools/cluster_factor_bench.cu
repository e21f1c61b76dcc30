// Times the phases of K6's cluster factor (csrc/bcr_common.cuh) on the card:
// the whole factor, ten passes of level 0's warp inverses, ten of its
// products and kept-knot updates, ten cluster barriers, and the set-up
// alone, at N = 64 and 256 over one cluster of 16 blocks of 512 threads (CUDA
// events over 20 launches).  The bands are a fixed well-conditioned system.
//
//   mkdir -p build && nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/cluster_factor_bench tools/cluster_factor_bench.cu && \
//     build/cluster_factor_bench
#include "../mpcgpu_tpu_torch/csrc/bcr_common.cuh"
#include <cstdio>
#include <vector>
#include <cmath>
constexpr int S = 14, SS = 196;
__global__ void __launch_bounds__(512) k_factor(int N, int lv, const float* SL, const float* SD, const float* SU, float* fac, int mode) {
  extern __shared__ float smem[];
  const pcgc::ClusterCg a = pcgc::cluster_area(smem, N, false);
  pcgc::cluster_load_bands(a, SL, SD, SU, a.SL, a.SD, a.SU);
  const bcr::BcrFactor f(fac, N, lv);
  if (mode == 0) { bcr::cluster_factor(f, a, a.extra); return; }
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int gw = a.rank * warps + warp, nw = a.C * warps;
  float* A = a.extra + 2 * SS * warp; float* B = A + SS;
  for (int e = threadIdx.x; e < SS * a.own; e += blockDim.x) {
    f.D[SS * a.k0 + e] = a.SD[e]; f.L[SS * a.k0 + e] = a.SL[e]; f.U[SS * a.k0 + e] = a.SU[e];
  }
  LD_CLUSTER_SYNC();
  for (int rep = 0; rep < 10; ++rep) {
    if (mode == 1) bcr::spread_inverses(f, 1, 2, gw, nw, A);
    if (mode == 2) bcr::spread_level(f, 0, gw, nw, A, B);
    if (mode == 3) { LD_CLUSTER_SYNC(); }
  }
}
int main() {
  for (int N : {64, 256}) {
    int lv = 0; while ((1 << lv) < N) ++lv;
    std::vector<float> h(3 * N * SS, 0.f);
    for (int k = 0; k < N; ++k) for (int i = 0; i < S; ++i) for (int j = 0; j < S; ++j) {
      h[SS * k + S * i + j] = (i == j) ? 0.0f : 0.0f;              // L
      h[N * SS + SS * k + S * i + j] = (i == j) ? 20.0f : 0.1f / (1 + i + j);  // D
      h[2 * N * SS + SS * k + S * i + j] = 0.05f * std::sin(i + 2 * j + k);   // U
    }
    for (int k = 1; k < N; ++k) for (int i = 0; i < S; ++i) for (int j = 0; j < S; ++j)
      h[SS * k + S * i + j] = h[2 * N * SS + SS * (k - 1) + S * j + i];  // L_k = U_{k-1}^T
    float *d, *fac;
    cudaMalloc(&d, h.size() * 4); cudaMemcpy(d, h.data(), h.size() * 4, cudaMemcpyHostToDevice);
    cudaMalloc(&fac, bcr::factor_floats(N) * 4);
    const int C = 16;
    size_t smem = pcgc::cluster_cg_floats(N, C, false, bcr::SCRATCH_FLOATS) * 4;
    cudaFuncSetAttribute(k_factor, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    cudaFuncSetAttribute(k_factor, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    cudaLaunchConfig_t cfg = {}; cfg.gridDim = dim3(C); cfg.blockDim = dim3(512); cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute at[1]; at[0].id = cudaLaunchAttributeClusterDimension; at[0].val.clusterDim.x = C; at[0].val.clusterDim.y = 1; at[0].val.clusterDim.z = 1;
    cfg.attrs = at; cfg.numAttrs = 1;
    const char* names[] = {"whole factor", "10 x level-0 inverses", "10 x level-0 products+update", "10 x cluster.sync", "setup only"};
    for (int mode = 0; mode < 5; ++mode) {
      for (int w = 0; w < 3; ++w) cudaLaunchKernelEx(&cfg, k_factor, N, lv, d, d + N * SS, d + 2 * N * SS, fac, mode);
      cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
      cudaEventRecord(a);
      for (int r = 0; r < 20; ++r) cudaLaunchKernelEx(&cfg, k_factor, N, lv, d, d + N * SS, d + 2 * N * SS, fac, mode);
      cudaEventRecord(b); cudaEventSynchronize(b);
      float ms; cudaEventElapsedTime(&ms, a, b);
      printf("N=%d %s: %.2f us per launch (err %d)\n", N, names[mode], 1e3 * ms / 20, (int)cudaGetLastError());
    }
  }
}
