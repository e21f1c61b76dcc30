// K4: warm-started stair-preconditioned CG on S lam = gamma, then dz; and
// K4b: the same CG without the dz; K4g and K4bg: the same in the joined
// form.
//
// Replaces the TPU kernels mpcgpu_tpu/ops/pallas/pcg_kernel.py
// (pcg_dz_pallas_lanes / _pcg_dz_kernel -> _pcg_loop) and
// (pcg_pallas_lanes / _pcg_kernel, the "pcg_pallas" backend's solve).  The loop is the
// reference's (MPCGPU alg. 2): exit when |eta| = |r' Pinv r| <= tol or at
// max_iter, hit = |eta| > tol at exit.  Then the primal step
//   dx_k = -Qinv_k (q_k - lam_k + A_k' lam_{k+1})   (no A term at k = N-1)
//   du_k = -Rinv_k (r_k + B_k' lam_{k+1}).
//
// Bound on the H100: latency.  At N = 64 one CG iteration is ~0.5 MFLOP
// over a 300 KB working set, and the iterations are a dependent chain with
// two global reductions each.  The kernels are K5's stage 4 as a launch of
// their own (pcg_common.cuh stair_dual_solve), in two forms:
// - the cluster form (K4, K4b): one thread-block cluster of C blocks of
//   128 threads (C = 16 where the card schedules it, else 8), each block
//   holding its knots' S bands, and the stair's where they fit, and its
//   rows of the CG vectors in shared memory: the halo rows through DSMEM,
//   the dots summed in rank order, two cluster barriers a CG step;
// - the joined form (K4g, K4bg): a cooperative cluster launch of G such
//   clusters, one CG across all of them, the dots' cluster sums and the
//   rows at the clusters' edges crossing as tagged words in global memory
//   (pcgc::JoinedExit), zeroed at the launch's start (one grid barrier),
//   with no grid barrier in the CG.
// The plan (pcg_plan) takes the cluster form while a block of it owns at
// most CLUSTER_CUT knots, and the joined form past that, on G clusters of
// 8 blocks (else 16, 4, 2, 1 where the card holds no clusters of 8) that
// give a block at most JOINED_KNOTS knots -- the rows of a block's knots
// one a thread -- as far as they are co-resident.  A CG's sums depend on (C, G) alone, so K4 and
// K4g equal K5's and K5g's dual solve at the same plan bit for bit.
#include "pcg_common.cuh"

#ifdef __CUDACC__
#include <map>
#endif

namespace {

constexpr int S = ld::NX;
constexpr int THREADS = 128;
// The longest horizon of the joined form, whose area may lie in global
// memory (place 0); it keeps the 32-bit offsets of its vectors far from
// overflow.
constexpr int MAX_KNOTS = 1 << 16;
// The cut between the forms: the most knots a block of the cluster form
// owns (on the H100 a CG step of the cluster form of 16 blocks takes 5.6
// us at 24 knots a block, N = 384, against the joined form's 5.7-5.8, and
// 6.4 at 32 against 5.9-6.0; tools/pcg_split.py, PERF.md), and the knots
// a block of the joined form aims at (its fastest steps on the H100,
// 5.7-6.4 us at N = 384-1024, at 7-8 knots a block: a row of each a
// thread).
constexpr int CLUSTER_CUT = 24;
constexpr int JOINED_KNOTS = 8;

enum Form { NONE = 0, CLUSTER = 1, JOINED = 2 };

struct PcgParams {
  pcgc::DualIn in;
  int N, max_iter, G, place;
  float tol;
  float *lam, *dX, *dU;
  int* iters;  // the CG count, then the cluster size read
  bool* hit;
  unsigned long long* words;  // the joined form: joined_words(G)
  float* vecs;                // the joined form at place 0: the vectors
};

template <bool DZ, bool JOINED_FORM>
LD_DEV void pcg_body(const PcgParams& p) {
  LD_DYN_SMEM(smem);
  float eta;
  int its;
  if constexpr (JOINED_FORM) {
    const int nt = LD_NTID;
    for (size_t e = (size_t)LD_BID * nt + LD_TID; e < pcgc::joined_words(p.G);
         e += (size_t)LD_NBID * nt)
      p.words[e] = 0;
    LD_GRID_SYNC();
    pcgc::ClusterCg a = pcgc::joined_area(smem, p.vecs, p.N, p.G, p.place);
    pcgc::JoinedExit ex{p.words, p.G, p.max_iter, p.tol};
    its = pcgc::stair_dual_solve<DZ>(a, p.place, p.in, ex, p.lam, p.dX, p.dU,
                                     &eta);
  } else {
    pcgc::ClusterCg a = pcgc::cluster_area(smem, p.N, p.place == 3);
    pcgc::LocalExit ex{p.max_iter, p.tol};
    its = pcgc::stair_dual_solve<DZ>(a, p.place, p.in, ex, p.lam, p.dX, p.dU,
                                     &eta);
  }
  if (LD_BID == 0 && LD_TID == 0) {
    p.iters[0] = its;
    p.iters[1] = ld_cluster_size();
    p.hit[0] = fabsf(eta) > p.tol;
  }
}

LD_GLOBAL void pcg_dz_cluster_kernel(PcgParams p) {
  pcg_body<true, false>(p);
}
LD_GLOBAL void pcg_solve_cluster_kernel(PcgParams p) {
  pcg_body<false, false>(p);
}
LD_GLOBAL void pcg_dz_joined_kernel(PcgParams p) {
  pcg_body<true, true>(p);
}
LD_GLOBAL void pcg_solve_joined_kernel(PcgParams p) {
  pcg_body<false, true>(p);
}

using PcgKernel = void (*)(PcgParams);

PcgKernel kernel_of(int form, int dz) {
  if (form == JOINED) return dz ? pcg_dz_joined_kernel : pcg_solve_joined_kernel;
  return dz ? pcg_dz_cluster_kernel : pcg_solve_cluster_kernel;
}

// Dynamic shared floats of a block of the form at (C, G, place).
size_t smem_floats(int form, int N, int C, int G, int place) {
  return form == JOINED ? pcgc::joined_cg_floats(N, C * G, place)
                        : pcgc::cluster_cg_floats(N, C, place == 3, 0);
}

// Whether the kernels take the form at (C, G, place) over N knots: C a
// power of 2 up to 16; the cluster form one cluster with S's bands on chip
// (place 2 or 3), the joined form G C <= N.
bool takes(int form, int N, int C, int G, int place) {
  if (N < 2 || N > MAX_KNOTS || C < 1 || C > 16 || (C & (C - 1)) || G < 1 ||
      place < 0 || place > 3)
    return false;
  return form == CLUSTER ? G == 1 && place >= 2
                         : form == JOINED && G * C <= N;
}

#ifdef __CUDACC__
// The clusters of C blocks of the form at (G, place) the card holds at
// once: 0 past a block's shared memory.  Kept per kernel, C and shared
// memory: every launch checks it, and the occupancy API's answer costs
// more host time than the launch.
int resident(int form, int dz, int N, int C, int G, int place) {
  static std::map<long long, int> known;
  const size_t bytes = smem_floats(form, N, C, G, place) * sizeof(float);
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const long long key =
      ((((long long)dev * 3 + form) * 2 + (dz != 0)) * 32 + C) * (1LL << 32)
      + (long long)bytes;
  const auto hit = known.find(key);
  if (hit != known.end()) return hit->second;
  int n = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) == cudaSuccess &&
      bytes <= (size_t)optin)
    n = pcgc::active_clusters((const void*)kernel_of(form, dz), C, THREADS,
                              bytes);
  return known[key] = n;
}
#endif

// Whether the card holds such a launch: a block's shared memory within the
// card's, and G clusters co-resident.  The host build, which runs any
// size, holds the cluster form to the card's fit at C = 16 (227 KB a
// block).
bool fits(int form, int dz, int N, int C, int G, int place) {
#ifdef __CUDACC__
  return resident(form, dz, N, C, G, place) >= G;
#else
  (void)dz;
  (void)C;
  return form == JOINED ||
         smem_floats(CLUSTER, N, 16, G, place) * sizeof(float) <= 232448;
#endif
}

bool admits(int form, int dz, int N, int C, int G, int place) {
  return takes(form, N, C, G, place) && fits(form, dz, N, C, G, place);
}

struct PcgPlan {
  int form = NONE, C = 0, G = 0, place = 0, grid = 0;
};

// The cluster form at C (C_req where it is not 0; else 16 where the card
// schedules it, else 8), the stair's bands on chip where they fit (or as
// place_req asks, 2 or 3).  The host build plans one block unless C_req
// asks for a size (its block emulation runs them), at the card's fit.
PcgPlan cluster_plan(int N, int dz, int C_req, int place_req) {
#ifdef __CUDACC__
  for (int C : {16, 8, C_req}) {
    if (C_req > 0 ? C != C_req : C == 0) continue;
#else
  {
    const int C = C_req > 0 ? C_req : 1;
#endif
    for (int place = 3; place >= 2; --place)
      if ((place_req < 0 || place == place_req) &&
          admits(CLUSTER, dz, N, C, 1, place))
        return PcgPlan{CLUSTER, C, 1, place, C};
  }
  return PcgPlan{};
}

// The joined form: C = C_req where it is not 0, else 8 (its steps 0.04-0.4
// us faster than at 16 on the H100 at N = 384-1024), or 16, 4, 2, 1 where
// the card holds no clusters of 8 (and C <= N); G the fewest clusters
// that give a block at most JOINED_KNOTS knots, held to the co-resident
// clusters; the CG's area the most on chip (place_req where it is 0-3) of
// the places that hold the most clusters up to that G.  The host build
// plans one block unless C_req asks for a size, and then N / C clusters of
// it.
PcgPlan joined_plan(int N, int dz, int C_req, int place_req) {
  PcgPlan pl;
#ifdef __CUDACC__
  for (int C : {8, 16, 4, 2, 1}) {
    if ((C_req > 0 && C != C_req) || C > N) continue;
    const int most = N / C;
    const int want = pcgc::cluster_knots(N, C * JOINED_KNOTS);
    for (int place = 3; place >= 0; --place) {
      if (place_req >= 0 && place != place_req) continue;
      // the largest G <= want the card holds: more clusters give a block
      // fewer knots and the card room for more, so stepping G down to
      // the clusters it holds ends there (or at 0)
      int G = want < most ? want : most;
      while (G > 0) {
        const int r = resident(JOINED, dz, N, C, G, place);
        if (r >= G) break;
        G = r;
      }
      if (G > pl.G) pl = PcgPlan{JOINED, C, G, place, C * G};
    }
    if (pl.G > 0) break;
  }
#else
  const int C = C_req > 0 ? C_req : 1;
  const int place = place_req >= 0 ? place_req : 3;
  const int G = C_req > 0 ? N / C : 1;
  if (admits(JOINED, dz, N, C, G, place))
    pl = PcgPlan{JOINED, C, G, place, C * G};
#endif
  return pl;
}

// form_req 0: the cluster form while a block of it owns at most
// CLUSTER_CUT knots, else the joined form; 1 or 2 that form.
PcgPlan pcg_plan(int N, int dz, int form_req, int C_req, int place_req) {
  if (N < 2 || N > MAX_KNOTS || C_req < 0 || C_req > 16 ||
      (C_req & (C_req - 1)) || place_req < -1 || place_req > 3)
    return PcgPlan{};
  if (form_req == JOINED) return joined_plan(N, dz, C_req, place_req);
  const PcgPlan cl = cluster_plan(N, dz, C_req, place_req);
  if (form_req == CLUSTER) return cl;
  // the cut, on the card's cluster size (16 in the host build)
#ifdef __CUDACC__
  const int C_cut = cl.C;
#else
  const int C_cut = 16;
#endif
  if (cl.form == CLUSTER && pcgc::cluster_knots(N, C_cut) <= CLUSTER_CUT)
    return cl;
  return joined_plan(N, dz, C_req, place_req);
}

}  // namespace

// The launch of K4 (dz != 0) or K4b over N knots: form 0 the plan's
// choice, 1 the cluster form (K4, K4b), 2 the joined form (K4g, K4bg); at
// the cluster size `cluster` asks (a power of 2 up to 16; 0 the plan's)
// and the CG's area where `place` asks (pcgc::joined_area's 0-3; the
// cluster form 2 or 3; -1 the plan's): writes the form, C, G, the place
// and the grid to out[0..4]; returns 0 where no launch fits, else 1.  A
// function of N and the device alone.
extern "C" int mpc_pcg_plan(int N, int dz, int form, int cluster, int place,
                            int* out) {
  PcgPlan pl;
#ifdef __CUDACC__
  static std::map<long long, PcgPlan> known;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const long long key =
      ((((long long)dev * 2 + (dz != 0)) * 4 + form) * 32 + cluster) * 8 +
      (place + 1);
  const auto hit = known.find(key * (MAX_KNOTS + 1) + N);
  if (hit != known.end()) {
    pl = hit->second;
  } else {
    pl = pcg_plan(N, dz, form, cluster, place);
    known[key * (MAX_KNOTS + 1) + N] = pl;
  }
#else
  pl = pcg_plan(N, dz, form, cluster, place);
#endif
  out[0] = pl.form;
  out[1] = pl.C;
  out[2] = pl.G;
  out[3] = pl.place;
  out[4] = pl.grid;
  return pl.form != NONE;
}

// Floats of global scratch a launch of the form at (C, G, place) takes.
extern "C" long long mpc_pcg_scratch_floats(int form, int N, int C, int G,
                                            int place) {
  if (form != JOINED) return 0;
  return (long long)(2 * pcgc::joined_words(G)
                     + (place == 0 ? (size_t)C * G
                                         * pcgc::joined_vec_floats(N, C * G)
                                   : 0));
}

// K4 (dz != 0) or K4b (dz == 0) in the form `form` (1 cluster, 2 joined)
// on G clusters of C blocks with the CG's area at `place` (as
// mpc_pcg_plan writes them): the stair-PCG from lam0, lam to lam_out, then
// for K4 dz (K4b reads none of A, B, q, r, Qinv, Rinv, dX and dU, which
// may be null).  iters holds 2 ints: the CG count and the cluster size the
// kernel read.  scratch holds mpc_pcg_scratch_floats(form, N, C, G, place)
// floats, 8-byte aligned.  Returns the launch's error: a size the kernels
// do not take, a block past the card's shared memory or clusters that
// cannot be co-resident are refused before any launch.
extern "C" int mpc_pcg(int dz, int N, const float* SL, const float* SD,
                       const float* SU, const float* PL, const float* PD,
                       const float* PU, const float* gamma,
                       const float* lam0, const float* A, const float* B,
                       const float* q, const float* r, const float* Qinv,
                       const float* Rinv, int max_iter, float tol,
                       float* lam_out, float* dX, float* dU, int* iters,
                       bool* hit, void* scratch, int form, int C, int G,
                       int place, void* stream) {
  if (!takes(form, N, C, G, place)) return 1;  // cudaErrorInvalidValue
  if (!fits(form, dz, N, C, G, place))
    return 720;  // cudaErrorCooperativeLaunchTooLarge
  PcgParams p;
  p.in = pcgc::DualIn{SL, SD, SU, PL, PD, PU, gamma, lam0, A, B, q, r, Qinv,
                      Rinv};
  p.N = N;
  p.max_iter = max_iter;
  p.G = G;
  p.place = place;
  p.tol = tol;
  p.lam = lam_out;
  p.dX = dX;
  p.dU = dU;
  p.iters = iters;
  p.hit = hit;
  p.words = reinterpret_cast<unsigned long long*>(scratch);
  p.vecs = form == JOINED && place == 0
               ? static_cast<float*>(scratch) + 2 * pcgc::joined_words(G)
               : nullptr;
  const int grid = C * G;
  const size_t smem = smem_floats(form, N, C, G, place) * sizeof(float);
  const PcgKernel kern = kernel_of(form, dz);
#ifdef __CUDACC__
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cfg.attrs = at;
  cfg.numAttrs = form == JOINED ? 2 : 1;
  err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
#else
  // the host build: one block walks every knot, or the block emulation
  // runs the C G blocks
  (void)stream;
  if (grid > 1)
    ld_emu_blocks(grid, C, smem / sizeof(float), [&] { kern(p); });
  else
    LD_LAUNCH(kern, 1, THREADS, smem, stream, p);
  return 0;
#endif
}
