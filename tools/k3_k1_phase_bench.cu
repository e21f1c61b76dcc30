// Times the phases of one knot of K3 (csrc/kkt_schur.cuh) and one substep of
// K1 (csrc/rollout.cu) on the card with clock64() stamps, and the kernels'
// whole launches with CUDA events.
//
// The kernels' sources are included with LD_STAMP defined, so thread 0 of
// block 0 records clock64() at the numbered boundaries the sources mark:
//   K3 stage 1 (k3::perknot): stamp 0 after the loads, then one after each
//     phase that ends in a block barrier (K3_PHASES below names them for
//     this tree);
//   K3 stages 2 and 3: k3::schur_bands and k3::stair, stamped around;
//   K1: stamps 20-23 around the first two substeps (an ABA and its Euler
//     step each; the first runs the code cold, the second from the caches);
//   K3's stage 1 run twice by one block (the second pass warm), as K5's
//     blocks run it knot after knot.
// Each phase's cycles are the median over REPS launches, printed with the
// microseconds they take at the card's reported SM clock.  Inputs are smooth
// seeded values and the model tables given as a raw float32 file (1680
// floats, lanedyn.cuh's TAB_* layout; argument 1), else synthetic ones:
// the timing does not depend on the values (no branch does).
//
//   mkdir -p build && python3 -c "import numpy as np; \
//     from mpcgpu_tpu_torch.models.robot import iiwa14; \
//     from mpcgpu_tpu_torch.ops.cuda._lib import model_tables; \
//     model_tables(iiwa14(device='cpu')).numpy().tofile('build/tables.f32')" && \
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas=-v \
//     -o build/k3_k1_phase_bench tools/k3_k1_phase_bench.cu && \
//   build/k3_k1_phase_bench build/tables.f32
#include <cstdio>
#include <cmath>
#include <vector>
#include <algorithm>

__device__ long long g_stamp[32];
#define LD_STAMP(i)                                                     \
  do {                                                                  \
    if (blockIdx.x == 0 && threadIdx.x == 0) g_stamp[(i)] = clock64();  \
  } while (0)

#include "../mpcgpu_tpu_torch/csrc/kkt_schur.cu"
#include "../mpcgpu_tpu_torch/csrc/rollout.cu"

namespace {

constexpr int REPS = 20;
constexpr int NX = ld::NX, NU = ld::NU;

// the phases between K3's stamps 0..5, in this tree's k3::perknot
const char* K3_PHASES[] = {
    "recursions: CRBA | RNEA bias | FK + Jacobian, a warp each",
    "Minv, qdd, rnea_primal (warp 0) | cost gradient, Q, Qinv (warp 1)",
    "14 tangent directions, 8 lanes each",
    "A, B and the predicted state",
    "Schur products (A Q^-1, T, Q^-1 q, tvec) and the stores"};
constexpr int N_K3_PHASES = sizeof(K3_PHASES) / sizeof(K3_PHASES[0]);

__global__ void bands_probe(int N, int k, const float* X, const float* Qinv,
                            const float* AQi, const float* T,
                            const float* tvec, const float* Qiq,
                            const float* fpred, float* SL, float* SD,
                            float* SU, float* PD, float* gamma, float* PL,
                            float* PU) {
  __syncthreads();
  LD_STAMP(10);
  k3::schur_bands(k, N, X, Qinv, AQi, T, tvec, Qiq, fpred, 1, SL, SD, SU, PD,
                  gamma);
  LD_STAMP(11);
  k3::stair(k, N, SL, SU, PD, 1, PL, PU);
  LD_STAMP(12);
}

__global__ void perknot_twice(const float* tab_g, int N, const float* X,
                              const float* U, const float* goals,
                              const float* rho, float* A, float* B,
                              float* Qinv, float* Rinv, float* q, float* r,
                              float* AQi, float* T, float* tvec, float* Qiq,
                              float* fpred) {
  __shared__ float tab[ld::TAB_SIZE];
  ld::load_tables(tab, tab_g);
  for (int pass = 0; pass < 2; ++pass)
    k3::perknot(tab, 0, N, X, U, goals, 3, rho, 0.01f, 1e-2f, 1e-3f, -9.81f,
                A, B, Qinv, Rinv, q, r, AQi, T, tvec, Qiq, fpred);
}

struct Dev {
  std::vector<float*> ptrs;
  float* alloc(size_t n, const std::vector<float>* init = nullptr) {
    float* p;
    cudaMalloc(&p, n * sizeof(float));
    if (init) cudaMemcpy(p, init->data(), n * sizeof(float), cudaMemcpyHostToDevice);
    else cudaMemset(p, 0, n * sizeof(float));
    ptrs.push_back(p);
    return p;
  }
  ~Dev() { for (float* p : ptrs) cudaFree(p); }
};

std::vector<long long> read_stamps() {
  std::vector<long long> s(32);
  cudaMemcpyFromSymbol(s.data(), g_stamp, 32 * sizeof(long long));
  return s;
}

long long median(std::vector<long long> v) {
  std::sort(v.begin(), v.end());
  return v[v.size() / 2];
}

double clock_ghz() {
  int khz = 0;
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  return khz * 1e-6;
}

void print_phase(const char* what, long long cycles, double ghz) {
  printf("  %-58s %7lld cycles  %7.2f us\n", what, cycles, cycles / (ghz * 1e3));
}

// K3's three launches at N knots: per-phase medians of block 0's stamps and
// the launches' event time.
void bench_k3(const float* tab, int N, double ghz) {
  Dev d;
  std::vector<float> X(N * NX), U((N - 1) * NU), goals(N * 3), rho(1, 1e-3f);
  for (int k = 0; k < N; ++k) {
    for (int i = 0; i < NX; ++i) X[NX * k + i] = 0.3f * std::sin(0.7f * i + 0.05f * k);
    for (int i = 0; i < 3; ++i) goals[3 * k + i] = 0.4f + 0.1f * std::cos(i + 0.1f * k);
  }
  for (size_t e = 0; e < U.size(); ++e) U[e] = 0.5f * std::sin(0.3f * e);
  float* Xd = d.alloc(X.size(), &X);
  float* Ud = d.alloc(std::max<size_t>(U.size(), 1), &U);
  float* gd = d.alloc(goals.size(), &goals);
  float* rd = d.alloc(1, &rho);
  const size_t b = (size_t)N * NX * NX;
  float *SL = d.alloc(b), *SD = d.alloc(b), *SU = d.alloc(b), *PL = d.alloc(b),
        *PD = d.alloc(b), *PU = d.alloc(b), *gam = d.alloc(N * NX),
        *Qinv = d.alloc(b), *Rinv = d.alloc(N * NU * NU), *A = d.alloc(b),
        *B = d.alloc(N * NX * NU), *q = d.alloc(N * NX), *r = d.alloc(N * NU),
        *AQi = d.alloc(b), *T = d.alloc(b), *tv = d.alloc(N * NX),
        *Qiq = d.alloc(N * NX), *fp = d.alloc(N * NX);
  auto launch = [&] {
    return mpc_kkt_schur(tab, N, Xd, Ud, gd, 3, rd, 0.01f, 1e-2f, 1e-3f,
                         -9.81f, 1, SL, SD, SU, PL, PD, PU, gam, Qinv, Rinv,
                         A, B, q, r, AQi, T, tv, Qiq, fp, nullptr);
  };
  std::vector<std::vector<long long>> ph(N_K3_PHASES + 2);
  for (int rep = 0; rep < REPS + 3; ++rep) {
    int err = launch();
    cudaDeviceSynchronize();
    if (err) { printf("K3 launch failed: %d\n", err); return; }
    const int k = N > 2 ? 1 : 0;
    bands_probe<<<1, 128>>>(N, k, Xd, Qinv, AQi, T, tv, Qiq, fp, SL, SD, SU,
                            PD, gam, PL, PU);
    cudaDeviceSynchronize();
    const std::vector<long long> s = read_stamps();
    if (rep < 3) continue;
    for (int p = 0; p < N_K3_PHASES; ++p) ph[p].push_back(s[p + 1] - s[p]);
    ph[N_K3_PHASES].push_back(s[11] - s[10]);
    ph[N_K3_PHASES + 1].push_back(s[12] - s[11]);
  }
  printf("K3 N = %d, block 0's knot (median of %d launches):\n", N, REPS);
  long long stage1 = 0;
  for (int p = 0; p < N_K3_PHASES; ++p) {
    print_phase(K3_PHASES[p], median(ph[p]), ghz);
    stage1 += median(ph[p]);
  }
  print_phase("stage 1 after the loads (sum of the medians)", stage1, ghz);
  std::vector<std::vector<long long>> warm(N_K3_PHASES);
  for (int rep = 0; rep < REPS + 3; ++rep) {
    perknot_twice<<<1, 128>>>(tab, N, Xd, Ud, gd, rd, A, B, Qinv, Rinv, q, r,
                              AQi, T, tv, Qiq, fp);
    cudaDeviceSynchronize();
    const std::vector<long long> s = read_stamps();
    if (rep >= 3)
      for (int p = 0; p < N_K3_PHASES; ++p) warm[p].push_back(s[p + 1] - s[p]);
  }
  long long stage1w = 0;
  for (int p = 0; p < N_K3_PHASES; ++p) stage1w += median(warm[p]);
  print_phase("stage 1, the same knot again in the block (warm)", stage1w, ghz);
  for (int p = 0; p < N_K3_PHASES; ++p) {
    char what[96];
    snprintf(what, sizeof what, "  warm: %.50s", K3_PHASES[p]);
    print_phase(what, median(warm[p]), ghz);
  }
  print_phase("stage 2: k3::schur_bands (one knot, one block)", median(ph[N_K3_PHASES]), ghz);
  print_phase("stage 3: k3::stair (one knot, one block)", median(ph[N_K3_PHASES + 1]), ghz);
  cudaEvent_t a, e;
  cudaEventCreate(&a);
  cudaEventCreate(&e);
  cudaEventRecord(a);
  for (int rep = 0; rep < REPS; ++rep) launch();
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  float ms = 0;
  cudaEventElapsedTime(&ms, a, e);
  printf("  K3's three launches at N = %d: %.2f us a call (events over %d "
         "calls, err %d)\n", N, 1e3 * ms / REPS, REPS, (int)cudaGetLastError());
}

void bench_k1(const float* tab, double ghz) {
  Dev d;
  const int n_ctrl = 63;
  std::vector<float> x(NX), U(n_ctrl * NU), g(3, 0.5f);
  for (int i = 0; i < NX; ++i) x[i] = 0.3f * std::sin(0.7f * i);
  for (size_t e = 0; e < U.size(); ++e) U[e] = 0.5f * std::sin(0.3f * e);
  float *xd = d.alloc(NX, &x), *Ud = d.alloc(U.size(), &U), *gd = d.alloc(3, &g),
        *xo = d.alloc(NX), *eo = d.alloc(1);
  auto launch = [&] {
    return mpc_rollout(tab, xd, Ud, n_ctrl, gd, 2000.0f, 2000.0f, 0.01f,
                       2e-4f, 11, -9.81f, xo, eo, nullptr);
  };
  std::vector<long long> sub, sub2;
  for (int rep = 0; rep < REPS + 3; ++rep) {
    int err = launch();
    cudaDeviceSynchronize();
    if (err) { printf("K1 launch failed: %d\n", err); return; }
    const std::vector<long long> s = read_stamps();
    if (rep >= 3) {
      sub.push_back(s[21] - s[20]);
      sub2.push_back(s[23] - s[22]);
    }
  }
  printf("K1 (median of %d launches):\n", REPS);
  print_phase("the first substep (ABA + Euler step)", median(sub), ghz);
  print_phase("the second substep", median(sub2), ghz);
  cudaEvent_t a, e;
  cudaEventCreate(&a);
  cudaEventCreate(&e);
  cudaEventRecord(a);
  for (int rep = 0; rep < REPS; ++rep) launch();
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  float ms = 0;
  cudaEventElapsedTime(&ms, a, e);
  printf("  K1's launch: %.2f us a call (events over %d calls, err %d)\n",
         1e3 * ms / REPS, REPS, (int)cudaGetLastError());
}

}  // namespace

int main(int argc, char** argv) {
  std::vector<float> tab(ld::TAB_SIZE);
  bool real = false;
  if (argc > 1) {
    FILE* f = std::fopen(argv[1], "rb");
    real = f && std::fread(tab.data(), sizeof(float), tab.size(), f) == tab.size();
    if (f) std::fclose(f);
  }
  if (!real)
    for (int e = 0; e < ld::TAB_SIZE; ++e) tab[e] = 0.1f * std::sin(0.37f * e);
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  const double ghz = clock_ghz();
  printf("%s, SM clock %.3f GHz (cudaDevAttrClockRate); %s tables\n",
         prop.name, ghz, real ? "the model's" : "synthetic");
  float* tabd;
  cudaMalloc(&tabd, tab.size() * sizeof(float));
  cudaMemcpy(tabd, tab.data(), tab.size() * sizeof(float), cudaMemcpyHostToDevice);
  bench_k1(tabd, ghz);
  for (int N : {2, 64, 256}) bench_k3(tabd, N, ghz);
  cudaFree(tabd);
  return 0;
}
