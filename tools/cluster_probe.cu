// A probe of thread-block clusters on the card: does a cluster launch take
// the cooperative attribute (grid.sync inside a cluster kernel)?  How many
// clusters of C blocks does cudaOccupancyMaxActiveClusters admit at a given
// dynamic shared memory?  What do cluster.sync, a split cluster barrier and
// grid.sync cost?  And what does a CG step's exit shared by B clusters
// cost (cross_wait: the two cluster barriers of a step alone, with every
// block reading the B clusters' published tags between the first
// barrier's arrive and wait, or with a grid.sync)?  Prints one line per
// answer.
//
//   mkdir -p build && nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/cluster_probe tools/cluster_probe.cu && build/cluster_probe
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cstdio>
namespace cg = cooperative_groups;

__global__ void coop_cluster(int* out, int iters) {
  extern __shared__ float sm[];
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cl = cg::this_cluster();
  unsigned nct;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(nct));
  if (threadIdx.x == 0) sm[0] = (float)cl.block_rank();
  for (int i = 0; i < iters; ++i) {
    cl.sync();
    grid.sync();
  }
  cl.sync();
  float* other = cl.map_shared_rank(sm, (cl.block_rank() + 1) % cl.num_blocks());
  float v = other[0];
  cl.sync();
  if (threadIdx.x == 0) {
    out[blockIdx.x * 3 + 0] = (int)nct;
    out[blockIdx.x * 3 + 1] = (int)v;
    out[blockIdx.x * 3 + 2] = (int)cl.block_rank();
  }
}

__global__ void cluster_only(int iters, float* out) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ float sm[];
  sm[threadIdx.x] = threadIdx.x;
  float acc = 0;
  for (int i = 0; i < iters; ++i) {
    cl.sync();
    float* other = cl.map_shared_rank(sm, (cl.block_rank() + 1) % cl.num_blocks());
    acc += other[threadIdx.x];
  }
  cl.sync();
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = acc;
}

__global__ void cluster_split(int iters, float* out) {
  cg::cluster_group cl = cg::this_cluster();
  extern __shared__ float sm[];
  float acc = 0;
  for (int i = 0; i < iters; ++i) {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  }
  if (threadIdx.x == 0 && blockIdx.x == 0) out[0] = acc;
}

__global__ void grid_only(int iters) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < iters; ++i) grid.sync();
}

__device__ unsigned long long ld_relaxed_u64(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ void st_relaxed_u64(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// B clusters of C blocks (the grid), `iters` steps of a cluster CG's
// barriers: mode 0 the two cluster barriers alone; mode 1 the same, each
// cluster's rank 0 publishing (step, value) in its own 64-bit slot (double
// buffered) after the second, warp 0 of every block waiting between the
// first barrier's arrive and wait until all B slots of the step before
// carry its tag; mode 2 the two cluster barriers and a grid.sync.
__global__ void cross_wait(int iters, int B, unsigned long long* slots,
                           int mode, int* bad) {
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cl = cg::this_cluster();
  __shared__ int flag;
  const int arm = blockIdx.x / cl.num_blocks();
  for (int i = 0; i < iters; ++i) {
    asm volatile("barrier.cluster.arrive.release;" ::: "memory");
    if (mode == 1 && i > 0 && threadIdx.x < 32) {
      int ok = 1;
      for (int a = threadIdx.x; a < B; a += 32) {
        unsigned long long v;
        do {
          v = ld_relaxed_u64(slots + (size_t)B * (i & 1) + a);
        } while ((unsigned)(v >> 32) != (unsigned)i);
        ok &= (int)(__uint_as_float((unsigned)v) == (float)i);
      }
      ok = __all_sync(0xffffffffu, ok);
      if (threadIdx.x == 0) flag = ok;
    }
    asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
    __syncthreads();
    if (mode == 1 && i > 0 && threadIdx.x == 0 && !flag) atomicAdd(bad, 1);
    if (mode == 2) grid.sync();
    cl.sync();
    if (mode == 1 && cl.block_rank() == 0 && threadIdx.x == 0)
      st_relaxed_u64(slots + (size_t)B * ((i + 1) & 1) + arm,
                     ((unsigned long long)(i + 1) << 32) |
                         __float_as_uint((float)(i + 1)));
  }
}

static int launch_coop_cluster(int csize, int grid, int threads, size_t smem,
                               int* out, int iters, bool coop) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = csize;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cfg.attrs = at;
  cfg.numAttrs = coop ? 2 : 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, coop_cluster, out, iters);
  return (int)e;
}

int main() {
  int dev = 0;
  cudaSetDevice(dev);
  cudaFuncSetAttribute(coop_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaFuncSetAttribute(cluster_only, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaFuncSetAttribute(cluster_split, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaFuncSetAttribute(coop_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, 220 * 1024);
  cudaFuncSetAttribute(cluster_only, cudaFuncAttributeMaxDynamicSharedMemorySize, 220 * 1024);
  cudaFuncSetAttribute(cluster_split, cudaFuncAttributeMaxDynamicSharedMemorySize, 220 * 1024);
  size_t smems[] = {0, 16 * 1024, 48 * 1024, 80 * 1024, 100 * 1024, 120 * 1024, 150 * 1024, 200 * 1024, 220 * 1024};
  for (int csize : {1, 2, 4, 8, 16}) {
    for (size_t sm : smems) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(csize * 64);
      cfg.blockDim = dim3(128);
      cfg.dynamicSmemBytes = sm;
      cudaLaunchAttribute at[1];
      at[0].id = cudaLaunchAttributeClusterDimension;
      at[0].val.clusterDim.x = csize;
      at[0].val.clusterDim.y = 1;
      at[0].val.clusterDim.z = 1;
      cfg.attrs = at;
      cfg.numAttrs = 1;
      int nclusters = -1;
      cudaError_t e = cudaOccupancyMaxActiveClusters(&nclusters, (void*)coop_cluster, &cfg);
      printf("maxActiveClusters C=%d smem=%zu -> %d (err %d) blocks %d\n", csize, sm, nclusters, (int)e, nclusters * csize);
      cudaGetLastError();
    }
  }
  int* out;
  cudaMalloc(&out, 4096 * 3 * sizeof(int));
  float* fo;
  cudaMalloc(&fo, 16);
  for (int csize : {8, 16}) {
    for (size_t sm : {(size_t)16 * 1024, (size_t)150 * 1024}) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(csize);
      cfg.blockDim = dim3(128);
      cfg.dynamicSmemBytes = sm;
      cudaLaunchAttribute at[1];
      at[0].id = cudaLaunchAttributeClusterDimension;
      at[0].val.clusterDim.x = csize;
      at[0].val.clusterDim.y = 1;
      at[0].val.clusterDim.z = 1;
      cfg.attrs = at;
      cfg.numAttrs = 1;
      int ncl = 0;
      cudaOccupancyMaxActiveClusters(&ncl, (void*)coop_cluster, &cfg);
      int grid = ncl * csize;
      for (bool coop : {true}) {
        int e = launch_coop_cluster(csize, grid, 128, sm, out, 10, coop);
        int e2 = (int)cudaDeviceSynchronize();
        int e3 = (int)cudaGetLastError();
        int h[6] = {0};
        cudaMemcpy(h, out, sizeof(h), cudaMemcpyDeviceToHost);
        printf("coop=%d cluster C=%d smem=%zu grid=%d: launch %d sync %d last %d; block0 nctarank %d nbr %d rank %d; block1 %d %d %d\n",
               (int)coop, csize, sm, grid, e, e2, e3, h[0], h[1], h[2], h[3], h[4], h[5]);
      }
      // timing of grid.sync + cluster.sync
      cudaEvent_t a, b;
      cudaEventCreate(&a);
      cudaEventCreate(&b);
      int iters = 2000;
      cudaEventRecord(a);
      int e = launch_coop_cluster(csize, grid, 128, sm, out, iters, true);
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      float ms = 0;
      cudaEventElapsedTime(&ms, a, b);
      printf("  coop+cluster C=%d grid=%d: %d x (cluster.sync + grid.sync) %.3f us each (launch %d)\n", csize, grid, iters, 1e3 * ms / iters, e);
      // cluster only, one cluster
      cfg.gridDim = dim3(csize);
      cudaEventRecord(a);
      cudaLaunchKernelEx(&cfg, cluster_only, iters, fo);
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      cudaEventElapsedTime(&ms, a, b);
      printf("  one cluster C=%d: %d x (cluster.sync + DSMEM read) %.3f us each (err %d)\n", csize, iters, 1e3 * ms / iters, (int)cudaGetLastError());
      cudaEventRecord(a);
      cudaLaunchKernelEx(&cfg, cluster_split, iters, fo);
      cudaEventRecord(b);
      cudaEventSynchronize(b);
      cudaEventElapsedTime(&ms, a, b);
      printf("  one cluster C=%d: %d x (arrive + wait) %.3f us each (err %d)\n", csize, iters, 1e3 * ms / iters, (int)cudaGetLastError());
    }
  }
  // the exit shared by B clusters, per CG step: the two cluster barriers
  // alone, with the tag wait between the first's arrive and wait, with a
  // grid.sync
  cudaFuncSetAttribute(cross_wait, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  unsigned long long* slots;
  cudaMalloc(&slots, 2 * 256 * sizeof(unsigned long long));
  int* bad;
  cudaMalloc(&bad, sizeof(int));
  for (int csize : {2, 4, 8, 16}) {
    for (int B : {1, 2, 4, 8, 16}) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(csize * B);
      cfg.blockDim = dim3(128);
      cudaLaunchAttribute at[2];
      at[0].id = cudaLaunchAttributeClusterDimension;
      at[0].val.clusterDim.x = csize;
      at[0].val.clusterDim.y = 1;
      at[0].val.clusterDim.z = 1;
      at[1].id = cudaLaunchAttributeCooperative;
      at[1].val.cooperative = 1;
      cfg.attrs = at;
      cfg.numAttrs = 1;
      int ncl = 0;
      cudaOccupancyMaxActiveClusters(&ncl, (void*)cross_wait, &cfg);
      cudaGetLastError();
      if (ncl < B) {
        printf("cross_wait C=%d B=%d: only %d clusters co-resident\n", csize, B, ncl);
        continue;
      }
      cfg.numAttrs = 2;
      const int iters = 4000;
      float us[3];
      int errs = 0, h_bad = 0;
      for (int mode = 0; mode < 3; ++mode) {
        cudaMemset(slots, 0, 2 * 256 * sizeof(unsigned long long));
        cudaMemset(bad, 0, sizeof(int));
        cudaEvent_t a, b;
        cudaEventCreate(&a);
        cudaEventCreate(&b);
        cudaEventRecord(a);
        cudaError_t e = cudaLaunchKernelEx(&cfg, cross_wait, iters, B, slots, mode, bad);
        cudaEventRecord(b);
        cudaEventSynchronize(b);
        float ms = 0;
        cudaEventElapsedTime(&ms, a, b);
        us[mode] = 1e3f * ms / iters;
        errs += (int)e + (int)cudaGetLastError();
        int hb = 0;
        cudaMemcpy(&hb, bad, sizeof(int), cudaMemcpyDeviceToHost);
        h_bad += hb;
      }
      printf("cross_wait C=%d B=%d grid=%d: two cluster barriers %.3f us a step, "
             "with the tag wait %.3f us (+%.3f), with a grid.sync %.3f us (+%.3f); "
             "errors %d, wrong reads %d\n",
             csize, B, csize * B, us[0], us[1], us[1] - us[0], us[2],
             us[2] - us[0], errs, h_bad);
    }
  }
  // plain cooperative grid.sync cost at 128, 132 and 264 blocks
  for (int g : {128, 132, 264}) {
    void* args[] = {(void*)new int(2000)};
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    cudaEventRecord(a);
    cudaError_t e = cudaLaunchCooperativeKernel((void*)grid_only, dim3(g), dim3(128), args, 0, 0);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms = 0;
    cudaEventElapsedTime(&ms, a, b);
    printf("grid.sync grid=%d: %.3f us each (err %d)\n", g, 1e3 * ms / 2000, (int)e);
  }
  return 0;
}
