// K6: warm-started CG on S lam = gamma preconditioned by an exact block
// cyclic reduction (BCR) solve, then dz.
//
// Replaces the TPU kernel mpcgpu_tpu/ops/pallas/bcr_kernel.py
// (bcr_pcg_dz_pallas_lanes / _bcr_pcg_dz_kernel -> _pcg_loop_bcrM,
// _bcr_lanes).  The loop is K4's (pcg_common.cuh) with z = BCR(r), no
// refinement, in place of the stair apply: exit when |eta| = |r' z| <= tol
// or at max_iter, hit = |eta| > tol at exit.  The dz epilogue is K4's.
//
// Design: factor once, apply many times.  The TPU kernel redoes the whole
// elimination of D, L, U -- log2(N) levels of 14x14 products and SPD
// inverses -- inside every preconditioner apply, though none of it depends
// on r.  Here one pass over the levels, before the CG loop, stores what the
// applies need:
//   per level l (h = 2^l) and kept knot i (i % 2h == 0):
//     LDm = L_i D_{i-h}^-1 and UDp = U_i D_{i+h}^-1;
//   per knot j, at the level where it is eliminated (and for the root):
//     Dinv_j, DL_j = Dinv_j L_j and DU_j = Dinv_j U_j,
// with kept knots updated in place (D -= LDm U_{i-h} + UDp L_{i+h},
// L = -LDm L_{i-h}, U = -UDp U_{i+h}).  An apply is then only the forward
// pass g_i -= LDm g_{i-h} + UDp g_{i+h} and the back substitution
// z_j = Dinv_j g_j - DL_j z_{j-h} - DU_j z_{j+h}: 2 log2(N) + 2 barriers.
// The factors take (6 + 2 log2 N) N 784 B in global memory (0.9 MB at
// N = 64), which stays in L2; the SPD inverses are lanedyn's warp
// Gauss-Jordan in shared memory, one warp per knot.
//
// Bound on the H100: latency, as K4 -- one block, S's bands and the CG
// vectors in shared memory, which bounds N (mpc_bcr_max_knots; power-of-2
// N only, the wrapper raises otherwise).
#include "pcg_common.cuh"

namespace {

constexpr int S = ld::NX, SS = S * S;
// 512 threads at most: the kernel's registers (96 a thread without a
// bound) times 896 threads would pass the SM's 65,536
constexpr int MAX_THREADS = 512, MAX_WARPS = MAX_THREADS / 32;

int levels_of(int N) {
  int l = 0;
  while ((1 << l) < N) ++l;
  return l;
}

// shared floats: S's bands, 5 CG vectors, the reduction slots and one
// 14x14 inverse scratch per warp
size_t bcr_smem_floats(int N) {
  return pcgc::cg_smem_floats(N, 5) + (size_t)MAX_WARPS * SS;
}

size_t bcr_scratch_floats(int N) {
  return (size_t)(6 + 2 * levels_of(N)) * N * SS;
}

// (A B)[i][j] for e = i*S + j, 14x14 row-major
LD_DEV float mm(const float* A, const float* B, int e) {
  const int i = e / S, j = e % S;
  float acc = 0.0f;
  for (int m = 0; m < S; ++m) acc += A[S * i + m] * B[S * m + j];
  return acc;
}

// row i of M (14x14) times x (14)
LD_DEV float mv_row(const float* M, const float* x, int i) {
  float acc = 0.0f;
  for (int m = 0; m < S; ++m) acc += M[S * i + m] * x[m];
  return acc;
}

struct BcrFactor {
  float* D;     // (N, S, S) working diagonal blocks
  float* L;     // (N, S, S) working lower blocks
  float* U;     // (N, S, S) working upper blocks
  float* Dinv;  // (N, S, S) at each knot's elimination level (root: knot 0)
  float* DL;    // (N, S, S) Dinv_j L_j
  float* DU;    // (N, S, S) Dinv_j U_j
  float* LDm;   // (levels, N, S, S), kept knots only
  float* UDp;   // (levels, N, S, S), kept knots only
  int N, levels;

  LD_DEV BcrFactor(float* base, int n, int lv) : N(n), levels(lv) {
    const size_t nb = (size_t)n * SS;
    D = base;
    L = D + nb;
    U = L + nb;
    Dinv = U + nb;
    DL = Dinv + nb;
    DU = DL + nb;
    LDm = DU + nb;
    UDp = LDm + (size_t)lv * nb;
  }
};

// Dinv[j] = D[j]^-1 for j = first, first + step, ... < N; one warp per knot.
LD_DEV void warp_inverses(const BcrFactor& f, int first, int step,
                          float* scratch) {
#ifdef __CUDACC__
  const int w = (int)threadIdx.x >> 5, nw = ((int)blockDim.x + 31) >> 5;
#else
  const int w = 0, nw = 1;
#endif
  float* A = scratch + SS * w;
  for (int j = first + w * step; j < f.N; j += nw * step) {
    for (int e = ld::lane(); e < SS; e += ld::lanes()) A[e] = f.D[SS * j + e];
    ld::warp_sync();
    ld::warp_spd_inverse<S>(A);
    for (int e = ld::lane(); e < SS; e += ld::lanes()) f.Dinv[SS * j + e] = A[e];
    ld::warp_sync();
  }
}

// The elimination, once per solve, from S's bands (shared memory).
LD_DEV void bcr_factor(const BcrFactor& f, const float* SL, const float* SD,
                       const float* SU, float* inv_scratch) {
  const int tid = LD_TID, nt = LD_NTID, n = f.N;
  for (int e = tid; e < n * SS; e += nt) {
    f.D[e] = SD[e];
    f.L[e] = SL[e];
    f.U[e] = SU[e];
  }
  LD_SYNC();
  for (int l = 0; l < f.levels; ++l) {
    const int h = 1 << l, nk = n / (2 * h);
    float* LDm = f.LDm + (size_t)l * n * SS;
    float* UDp = f.UDp + (size_t)l * n * SS;
    warp_inverses(f, h, 2 * h, inv_scratch);   // knots eliminated at l
    LD_SYNC();
    for (int e = tid; e < nk * SS; e += nt) {
      const int i = (e / SS) * 2 * h, j = i + h, ee = e % SS;
      LDm[SS * i + ee] = i >= h ? mm(f.L + SS * i, f.Dinv + SS * (i - h), ee) : 0.0f;
      UDp[SS * i + ee] = mm(f.U + SS * i, f.Dinv + SS * j, ee);
      f.DL[SS * j + ee] = mm(f.Dinv + SS * j, f.L + SS * j, ee);
      f.DU[SS * j + ee] = j + h <= n - 1 ? mm(f.Dinv + SS * j, f.U + SS * j, ee) : 0.0f;
    }
    LD_SYNC();
    // kept knots: read only their eliminated neighbours, write themselves
    for (int e = tid; e < nk * SS; e += nt) {
      const int i = (e / SS) * 2 * h, ee = e % SS;
      float d = f.D[SS * i + ee] - mm(UDp + SS * i, f.L + SS * (i + h), ee);
      float lo = 0.0f;
      if (i >= h) {
        d -= mm(LDm + SS * i, f.U + SS * (i - h), ee);
        lo = -mm(LDm + SS * i, f.L + SS * (i - h), ee);
      }
      const float up = -mm(UDp + SS * i, f.U + SS * (i + h), ee);
      f.D[SS * i + ee] = d;
      f.L[SS * i + ee] = lo;
      f.U[SS * i + ee] = up;
    }
    LD_SYNC();
  }
  warp_inverses(f, 0, n, inv_scratch);         // the root
  LD_SYNC();
}

// z = BCR(r) from the stored factors; returns this thread's part of r . z.
// g is an (N, S) shared scratch vector.
struct BcrPre {
  BcrFactor f;
  float* g;
  LD_DEV float apply(const float* r, float* z) const {
    const int tid = LD_TID, nt = LD_NTID, n = f.N;
    for (int e = tid; e < n * S; e += nt) g[e] = r[e];
    LD_SYNC();
    for (int l = 0; l < f.levels; ++l) {
      const int h = 1 << l, nk = n / (2 * h);
      const float* LDm = f.LDm + (size_t)l * n * SS;
      const float* UDp = f.UDp + (size_t)l * n * SS;
      for (int e = tid; e < nk * S; e += nt) {
        const int i = (e / S) * 2 * h, row = e % S;
        float acc = g[S * i + row] - mv_row(UDp + SS * i, g + S * (i + h), row);
        if (i >= h) acc -= mv_row(LDm + SS * i, g + S * (i - h), row);
        g[S * i + row] = acc;
      }
      LD_SYNC();
    }
    for (int e = tid; e < S; e += nt) z[e] = mv_row(f.Dinv, g, e);
    LD_SYNC();
    for (int l = f.levels - 1; l >= 0; --l) {
      const int h = 1 << l, nk = n / (2 * h);
      for (int e = tid; e < nk * S; e += nt) {
        const int j = (e / S) * 2 * h + h, row = e % S;
        float acc = mv_row(f.Dinv + SS * j, g + S * j, row)
                    - mv_row(f.DL + SS * j, z + S * (j - h), row);
        if (j + h <= n - 1) acc -= mv_row(f.DU + SS * j, z + S * (j + h), row);
        z[S * j + row] = acc;
      }
      LD_SYNC();
    }
    float part = 0.0f;
    for (int e = tid; e < n * S; e += nt) part += r[e] * z[e];
    return part;
  }
};

LD_GLOBAL void LD_LAUNCH_BOUNDS(MAX_THREADS) bcr_pcg_dz_kernel(
    int N, int levels, const float* SLg, const float* SDg, const float* SUg,
    const float* gamma, const float* lam0, const float* A, const float* B,
    const float* q, const float* r_in, const float* Qinv, const float* Rinv,
    int max_iter, float tol, float* fac, float* lam_out, float* dX,
    float* dU, int* iters_out, bool* hit_out) {
  LD_DYN_SMEM(smem);
  const int nb = SS * N, n = S * N;
  float* SL = smem;
  float* SD = SL + nb;
  float* SU = SD + nb;
  float* lam = SU + nb;
  float* r = lam + n;
  float* p = r + n;
  float* w = p + n;
  float* g = w + n;
  float* red = g + n;
  float* inv = red + 33;
  pcgc::load_system(N, SLg, SDg, SUg, lam0, SL, SD, SU, lam);
  const BcrFactor f(fac, N, levels);
  bcr_factor(f, SL, SD, SU, inv);
  float eta;
  const int it = pcgc::cg_solve(N, SL, SD, SU, gamma, lam, r, p, w, red,
                                BcrPre{f, g}, max_iter, tol, &eta);
  if (LD_TID == 0) {
    iters_out[0] = it;
    hit_out[0] = fabsf(eta) > tol;
  }
  pcgc::dz_epilogue(N, lam, A, B, q, r_in, Qinv, Rinv, r, p, lam_out, dX,
                    dU);
}

}  // namespace

// Largest power-of-2 horizon whose S bands, CG vectors and inverse scratch
// fit one block's shared memory on this device; 0 if it cannot be read.
extern "C" int mpc_bcr_max_knots(void) {
  const int n = pcgc::max_knots_for(bcr_smem_floats, 0);
  int p = 0;
  while ((2 << p) <= n) ++p;
  return n > 0 ? 1 << p : 0;
}

// Floats of global scratch the factors of an N-knot solve take.
extern "C" long long mpc_bcr_scratch_floats(int N) {
  return (long long)bcr_scratch_floats(N);
}

extern "C" int mpc_bcr_pcg_dz(int N, const float* SL, const float* SD,
                              const float* SU, const float* gamma,
                              const float* lam0, const float* A,
                              const float* B, const float* q, const float* r,
                              const float* Qinv, const float* Rinv,
                              int max_iter, float tol, float* scratch,
                              float* lam_out, float* dX, float* dU,
                              int* iters, bool* hit, void* stream) {
  if (N < 1 || (N & (N - 1))) return 1;  // cudaErrorInvalidValue
  const size_t smem = bcr_smem_floats(N) * sizeof(float);
#ifdef __CUDACC__
  cudaError_t err = cudaFuncSetAttribute(
      bcr_pcg_dz_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
#endif
  int threads = ((S * N + 31) / 32) * 32;
  if (threads > MAX_THREADS) threads = MAX_THREADS;
  LD_LAUNCH(bcr_pcg_dz_kernel, 1, threads, smem, stream, N, levels_of(N), SL,
            SD, SU, gamma, lam0, A, B, q, r, Qinv, Rinv, max_iter, tol,
            scratch, lam_out, dX, dU, iters, hit);
  return LD_LAST_ERROR();
}
