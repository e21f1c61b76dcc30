// Times the phases of one knot of K3 (csrc/kkt_schur.cuh), one substep of
// K1 (csrc/rollout.cu), one merit contribution of K2 (csrc/merit.cuh) and
// K5's merit stages (csrc/sqp_mega.cu) on the card with clock64() stamps,
// and the kernels' whole launches with CUDA events.
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
//     blocks run it knot after knot;
//   K2: stamps 30-34 around the phases of block 0's first contribution
//     (candidate 0, knot 0; K2_PHASES names them);
//   K5: stamps 40 + 3 it, 41 + 3 it and 42 + 3 it at the start of SQP
//     iteration it's stage 5 (the merit contributions of every (candidate,
//     knot) pair, after the grid barrier that ends the dual solve), at its
//     end (after the next grid barrier) and after stage 6's sums (each
//     candidate's N contributions in knot order, in every block), with the
//     CG capped at 0, at N = 64, 256 and 512, at K5's group size and at each
//     of 8, 16 and 32 (LD_MERIT_GROUP);
//   K2 also at each group size, and one pair on groups of 8, 16 and 32
//     lanes read back whole (bits_k2: where the 8- and 16-lane forms part
//     from the 32-lane form's bits).
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
//     -o build/phase_bench tools/phase_bench.cu && \
//   build/phase_bench build/tables.f32
#include <cstdio>
#include <cmath>
#include <cstring>
#include <vector>
#include <algorithm>
#include <functional>
#include <string>
#include <map>

constexpr int N_STAMPS = 64;
__device__ long long g_stamp[N_STAMPS];
#define LD_STAMP(i)                                                     \
  do {                                                                  \
    if (blockIdx.x == 0 && threadIdx.x == 0) g_stamp[(i)] = clock64();  \
  } while (0)

// the megakernels' merit group size, when set (0: the kernels' own choice)
__device__ int g_merit_group;
#define LD_MERIT_GROUP(G) (g_merit_group ? g_merit_group : (G))

#include "../mpcgpu_tpu_torch/csrc/kkt_schur.cu"
#include "../mpcgpu_tpu_torch/csrc/rollout.cu"
#include "../mpcgpu_tpu_torch/csrc/merit.cuh"
#include "../mpcgpu_tpu_torch/csrc/pcg_common.cuh"
#include "../mpcgpu_tpu_torch/csrc/bcr_common.cuh"
// merit.cu's and sqp_mega.cu's file-local names (THREADS, S, ...) would
// clash with kkt_schur.cu's: each goes in a namespace of its own
namespace k2src {
#include "../mpcgpu_tpu_torch/csrc/merit.cu"
}
namespace k5src {
#include "../mpcgpu_tpu_torch/csrc/sqp_mega.cu"
}

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

// the phases between K2's stamps 30..34, in this tree's k2::merit_contrib
const char* K2_PHASES[] = {
    "the candidate's rows, sin and cos of q",
    "joint transforms | end-effector FK",
    "ABA for qdd",
    "costs, L1 defects and the x0 term (every lane)"};
constexpr int N_K2_PHASES = sizeof(K2_PHASES) / sizeof(K2_PHASES[0]);

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
                ld::Knobs{}, A, B, Qinv, Rinv, q, r, AQi, T, tvec, Qiq,
                fpred);
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
  std::vector<long long> s(N_STAMPS);
  cudaMemcpyFromSymbol(s.data(), g_stamp, N_STAMPS * sizeof(long long));
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

float event_us(int reps, const std::function<int()>& launch) {
  cudaEvent_t a, e;
  cudaEventCreate(&a);
  cudaEventCreate(&e);
  cudaEventRecord(a);
  for (int rep = 0; rep < reps; ++rep) launch();
  cudaEventRecord(e);
  cudaEventSynchronize(e);
  float ms = 0;
  cudaEventElapsedTime(&ms, a, e);
  cudaEventDestroy(a);
  cudaEventDestroy(e);
  return 1e3f * ms / reps;
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
                         A, B, q, r, AQi, T, tv, Qiq, fp, 0, 0, 0, 0, 1.0f,
                         nullptr);
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
  printf("  K3's three launches at N = %d: %.2f us a call (events over %d "
         "calls, err %d)\n", N, event_us(REPS, launch), REPS,
         (int)cudaGetLastError());
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
  printf("  K1's launch: %.2f us a call (events over %d calls, err %d)\n",
         event_us(REPS, launch), REPS, (int)cudaGetLastError());
}

// Smooth seeded candidate inputs of N knots (the timing does not depend on
// the values).
struct MeritInputs {
  std::vector<float> X, U, dX, dU, goals, xs;
  explicit MeritInputs(int N)
      : X(N * NX), U((N - 1) * NU), dX(N * NX), dU((N - 1) * NU),
        goals(N * 3), xs(NX) {
    for (int k = 0; k < N; ++k) {
      for (int i = 0; i < NX; ++i) {
        X[NX * k + i] = 0.3f * std::sin(0.7f * i + 0.05f * k);
        dX[NX * k + i] = 0.01f * std::cos(0.3f * i + 0.11f * k);
      }
      for (int i = 0; i < 3; ++i) goals[3 * k + i] = 0.4f + 0.1f * std::cos(i + 0.1f * k);
    }
    for (size_t e = 0; e < U.size(); ++e) {
      U[e] = 0.5f * std::sin(0.3f * e);
      dU[e] = 0.02f * std::cos(0.2f * e);
    }
    for (int i = 0; i < NX; ++i) xs[i] = X[i] + 0.01f;
  }
};


// K2 at N knots, 8 candidates and the base point, with groups of `group`
// lanes (0: K2's choice): the phases of block 0's first contribution and
// the launch's event time.
void bench_k2(const float* tab, int N, int group, double ghz) {
  Dev d;
  MeritInputs in(N);
  float *Xd = d.alloc(in.X.size(), &in.X), *Ud = d.alloc(in.U.size(), &in.U),
        *dXd = d.alloc(in.dX.size(), &in.dX), *dUd = d.alloc(in.dU.size(), &in.dU),
        *gd = d.alloc(in.goals.size(), &in.goals), *xsd = d.alloc(NX, &in.xs),
        *out = d.alloc(9), *contrib = d.alloc(9 * N);
  unsigned* done = reinterpret_cast<unsigned*>(d.alloc(1));
  auto launch = [&] {
    return k2src::mpc_merits(tab, Xd, Ud, dXd, dUd, gd, 3, xsd, N, 8, 0.01f,
                             1.0f, 1e-2f, 1e-3f, -9.81f, contrib, done, group,
                             out, 0, 0, 0, 0, 1.0f, nullptr);
  };
  std::vector<std::vector<long long>> ph(N_K2_PHASES + 1);
  for (int rep = 0; rep < REPS + 3; ++rep) {
    const int err = launch();
    cudaDeviceSynchronize();
    if (err) { printf("K2 launch failed: %d\n", err); return; }
    const std::vector<long long> s = read_stamps();
    if (rep < 3) continue;
    for (int p = 0; p < N_K2_PHASES; ++p) ph[p].push_back(s[31 + p] - s[30 + p]);
    ph[N_K2_PHASES].push_back(s[30 + N_K2_PHASES] - s[30]);
  }
  printf("K2 N = %d, groups of %s lanes, block 0's first contribution "
         "(median of %d launches):\n", N,
         group ? std::to_string(group).c_str() : "K2's choice of", REPS);
  for (int p = 0; p < N_K2_PHASES; ++p) print_phase(K2_PHASES[p], median(ph[p]), ghz);
  print_phase("one contribution", median(ph[N_K2_PHASES]), ghz);
  printf("  K2's launch at N = %d: %.2f us a call (events over %d calls, "
         "err %d)\n", N, event_us(REPS, launch), REPS, (int)cudaGetLastError());
}

// K5 at N knots, 4 SQP iterations with the CG capped at 0, its merit
// stage on groups of `group` lanes (0: K5's choice): stage 5 (the merit
// contributions) and stage 6 (the sums in knot order) per iteration.
void bench_k5(const float* tab, int N, int group, double ghz) {
  cudaMemcpyToSymbol(g_merit_group, &group, sizeof(int));
  Dev d;
  MeritInputs in(N);
  const int n_sqp = 4, kind = k5src::SOLVE_PCG;
  std::vector<float> one(1, 1e-3f), big(1, 1e30f);
  float *X0 = d.alloc(in.X.size(), &in.X), *U0 = d.alloc(in.U.size(), &in.U),
        *gd = d.alloc(in.goals.size(), &in.goals), *xsd = d.alloc(NX, &in.xs),
        *lam0 = d.alloc(N * NX), *rho0 = d.alloc(1, &one),
        *merit0 = d.alloc(1, &big), *X = d.alloc(N * NX),
        *U = d.alloc((N - 1) * NU), *lam = d.alloc(N * NX), *scal = d.alloc(4),
        *scratch = d.alloc(k5src::mpc_sqp_mega_scratch_floats(N, 8, kind));
  int *ints, *stats, *iscratch;
  cudaMalloc(&ints, 2 * sizeof(int));
  cudaMalloc(&stats, 3 * n_sqp * sizeof(int));
  cudaMalloc(&iscratch, 3 * sizeof(int));
  const int grid = k5src::mpc_mega_grid(N, kind);
  auto launch = [&] {
    return k5src::mpc_sqp_mega(
        tab, N, X0, U0, gd, 3, xsd, lam0, rho0, merit0, 1.0f, 0, 5e-5f, n_sqp,
        0.01f, 1e-2f, 1e-3f, -9.81f, 1.0f, 8, 1.2f, 1e-3f, 1e3f, 1e-3f, X, U,
        lam, scal, ints, stats, scratch, iscratch, kind, grid, 0, -1, 0, 0, 0,
        0, 1.0f, nullptr);
  };
  std::vector<std::vector<long long>> s5(n_sqp), s6(n_sqp);
  for (int rep = 0; rep < REPS + 3; ++rep) {
    cudaMemcpyToSymbol(g_stamp, std::vector<long long>(N_STAMPS, 0).data(),
                       N_STAMPS * sizeof(long long));
    const int err = launch();
    cudaDeviceSynchronize();
    if (err) { printf("K5 launch failed at N = %d: %d\n", N, err); return; }
    const std::vector<long long> s = read_stamps();
    if (rep < 3) continue;
    for (int it = 0; it < n_sqp; ++it) {
      const long long* t = &s[40 + 3 * it];
      if (!t[0]) continue;  // the iteration did not run (a bail)
      s5[it].push_back(t[1] - t[0]);
      s6[it].push_back(t[2] - t[1]);
    }
  }
  printf("K5 N = %d, grid %d, merit groups of %s lanes, CG capped at 0 "
         "(median of %d launches):\n", N, grid,
         group ? std::to_string(group).c_str() : "K5's choice of", REPS);
  for (int it = 0; it < n_sqp; ++it) {
    if (s5[it].empty()) continue;
    char what[96];
    snprintf(what, sizeof what, "iteration %d stage 5: %d merit contributions", it,
             8 * N);
    print_phase(what, median(s5[it]), ghz);
    snprintf(what, sizeof what, "iteration %d stage 6: 8 sums of %d in knot order",
             it, N);
    print_phase(what, median(s6[it]), ghz);
  }
  printf("  K5's launch at N = %d: %.2f us a call (events over %d calls, "
         "err %d)\n", N, event_us(REPS, launch), REPS, (int)cudaGetLastError());
  cudaFree(ints);
  cudaFree(stats);
  cudaFree(iscratch);
  const int zero = 0;
  cudaMemcpyToSymbol(g_merit_group, &zero, sizeof(int));
}

// One pair's contribution on the groups of G lanes of one warp: group 0's
// whole area after the routine (its inputs, ee, qdd, the transforms and
// ABA's last intermediates), then the contribution.
template <int G>
__global__ void merit_pair_probe(const float* tab_g, const float* X,
                                 const float* U, const float* dX,
                                 const float* dU, const float* goals,
                                 const float* xs, int N, int k, float alpha,
                                 float* out) {
  __shared__ float tab[ld::TAB_SIZE];
  __shared__ float area[k2::AREA_FLOATS * (32 / G)];
  ld::load_tables(tab, tab_g);
  const float v = k2::merit_contrib<G>(
      ld::group(G, true), tab, area + k2::AREA_FLOATS * (threadIdx.x / G), X,
      dX, U, dU, k, N, alpha, goals + 3 * k, xs, 0.01f, 1.0f, 1e-2f, 1e-3f,
      -9.81f, ld::Knobs{});
  __syncwarp();
  if (threadIdx.x == 0) {
    for (int e = 0; e < k2::AREA_FLOATS; ++e) out[e] = area[e];
    out[k2::AREA_FLOATS] = v;
  }
}


// Where groups of 8 and 16 lanes part from groups of 32 on one pair: the
// first differing entry of each named part of the area, and the value.
void bits_k2(const float* tab) {
  const int N = 64, F = k2::AREA_FLOATS + 1;
  Dev d;
  MeritInputs in(N);
  float *Xd = d.alloc(in.X.size(), &in.X), *Ud = d.alloc(in.U.size(), &in.U),
        *dXd = d.alloc(in.dX.size(), &in.dX), *dUd = d.alloc(in.dU.size(), &in.dU),
        *gd = d.alloc(in.goals.size(), &in.goals), *xsd = d.alloc(NX, &in.xs),
        *o8 = d.alloc(F), *o16 = d.alloc(F), *o32 = d.alloc(F);
  struct Part { const char* name; int lo, hi; };
  const int W = k2::A_W;
  const Part parts[] = {
      {"x xn u", 0, k2::A_S}, {"sin cos", k2::A_S, k2::A_EE},
      {"ee", k2::A_EE, k2::A_QDD}, {"qdd", k2::A_QDD, k2::A_QDD + 7},
      {"Xj", k2::A_XJ, W}, {"aba v", W, W + 42}, {"aba cvel", W + 42, W + 84},
      {"aba Iv", W + 84, W + 126}, {"aba pA", W + 126, W + 168},
      {"aba IA", W + 168, W + 204}, {"aba Ia", W + 204, W + 240},
      {"aba AX", W + 240, W + 276}, {"aba pa", W + 276, W + 282},
      {"aba Uc", W + 282, W + 324}, {"aba dc uc", W + 324, W + 338},
      {"aba an", W + 338, W + 380}, {"contribution", F - 1, F}};
  for (int k : {0, 1, 30, 63})
    for (float alpha : {1.0f, 0.125f}) {
      merit_pair_probe<8><<<1, 32>>>(tab, Xd, Ud, dXd, dUd, gd, xsd, N, k, alpha, o8);
      merit_pair_probe<16><<<1, 32>>>(tab, Xd, Ud, dXd, dUd, gd, xsd, N, k, alpha, o16);
      merit_pair_probe<32><<<1, 32>>>(tab, Xd, Ud, dXd, dUd, gd, xsd, N, k, alpha, o32);
      std::vector<float> h8(F), h16(F), h32(F);
      cudaMemcpy(h8.data(), o8, F * 4, cudaMemcpyDeviceToHost);
      cudaMemcpy(h16.data(), o16, F * 4, cudaMemcpyDeviceToHost);
      cudaMemcpy(h32.data(), o32, F * 4, cudaMemcpyDeviceToHost);
      printf("K2 pair k = %d, alpha = %g (err %d): parts where 8 | 16 lanes "
             "differ from 32:", k, alpha, (int)cudaGetLastError());
      bool any = false;
      for (const Part& pt : parts)
        for (int gi = 0; gi < 2; ++gi) {
          const std::vector<float>& h = gi ? h16 : h8;
          double worst = 0.0;
          int first = -1;
          for (int e = pt.lo; e < pt.hi; ++e)
            if (std::memcmp(&h[e], &h32[e], 4)) {
              if (first < 0) first = e - pt.lo;
              worst = std::max(worst, (double)std::fabs(h[e] - h32[e]));
            }
          if (first >= 0) {
            printf(" [%s, %d lanes: from entry %d, up to %.3g]", pt.name,
                   gi ? 16 : 8, first, worst);
            any = true;
          }
        }
      printf("%s\n", any ? "" : " none");
    }
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
  for (int N : {64, 256, 1024})
    for (int group : {0, 8, 16, 32}) bench_k2(tabd, N, group, ghz);
  bits_k2(tabd);
  for (int N : {64, 256, 512})
    for (int group : {0, 8, 16, 32}) bench_k5(tabd, N, group, ghz);
  cudaFree(tabd);
  return 0;
}
