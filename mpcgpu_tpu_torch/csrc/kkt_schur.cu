// K3: KKT linearization, Schur condensation and stair preconditioner.
//
// Replaces the TPU kernel mpcgpu_tpu/ops/pallas/kkt_schur_kernel.py
// (form_kkt_schur_pallas / _kernel -> _perknot).  Knot-major outputs:
// S = (SL, SD, SU) and Pinv = (PL, PD, PU) as (N, 14, 14) bands, gamma
// (N, 14), and the blocks primal recovery needs: Qinv (N, 14, 14),
// Rinv (N, 7, 7), A (N, 14, 14), B (N, 14, 7), q (N, 14), r (N, 7), with
// A, B, Rinv and r zero at the last knot (it has no control).
//
// Three launches of one 128-thread block per knot, separated by the launch
// boundaries that the cross-knot terms need:
//   1. per knot: dynamics and their gradient (CRBA, Minv, RNEA bias, the
//      hand-written RNEA tangents, dqdd = -Minv dtau), explicit-Euler A, B
//      and the predicted state, the eepos cost gradient and rank-1
//      Hessian, rho-regularized Q^-1 and R^-1, and the per-knot Schur
//      products A Q^-1, T = A Q^-1 A' + B R^-1 B', Q^-1 q and
//      A Q^-1 q + B R^-1 r into scratch;
//   2. per knot with its left neighbour: theta, phi (SL), SU, gamma with
//      the defect c_k = x_k - f(x_{k-1}, u_{k-1}) (c_0 left out, as in the
//      reference), and PD = theta^-1;
//   3. per knot with both neighbours: PL = -theta_k^-1 phi_k theta_{k-1}^-1
//      and PU = -theta_k^-1 SU_k theta_{k+1}^-1.
//
// Bound on the H100: latency.  N = 64 knots fill 64 of 132 SMs with one
// block each, and a knot's work is a chain of small dependent steps.  One
// thread per knot (the TPU's lane-per-knot form) spills past 255 registers
// and runs the whole chain serially.  So each knot gets a block: the three
// independent recursions (CRBA, RNEA bias, FK + Jacobian) run as single
// threads of three warps at once, the 14 tangent directions run on 14
// threads, the 7x7 and 14x14 SPD inverses are warp-parallel Gauss-Jordan,
// and every 14x14 product gives each output entry its own thread, with all
// intermediates in shared memory.
#include "lanedyn.cuh"

namespace {

constexpr int NX = ld::NX, NU = ld::NU, NQ = ld::NQ;
constexpr int THREADS = 128;

LD_GLOBAL void k3_perknot(const float* __restrict__ tab_g, int N,
                          const float* __restrict__ X,
                          const float* __restrict__ U,
                          const float* __restrict__ goals, int gstride,
                          const float* __restrict__ rho_p, float dt,
                          float qd_cost, float r_cost, float grav,
                          float* A_o, float* B_o, float* Qinv_o,
                          float* Rinv_o, float* q_o, float* r_o,
                          float* AQi_s, float* T_s, float* tvec_s,
                          float* Qiq_s, float* fpred_s) {
  LD_SHARED float tab[ld::TAB_SIZE];
  LD_SHARED float x[NX], u[NU], s[NQ], c[NQ], zero[NQ], bias[NQ], qdd[NQ];
  LD_SHARED float M[NQ * NQ], ee[3], J[3 * NQ], qg[NX], rg[NU];
  LD_SHARED float dtau[NQ * NX], A[NX * NX], B[NX * NU], Q[NX * NX];
  LD_SHARED float AQi[NX * NX], BRi[NX * NU];
  LD_SHARED ld::RneaPrimal prim;
  const int k = LD_BID, t = LD_TID, nt = LD_NTID;
  const bool has_u = k < N - 1;
  const float rho = rho_p[0];
  const float rinv = 1.0f / (r_cost + rho);  // R = r_cost I: Rr^-1 is diagonal
  const float* g = goals + gstride * k;

  for (int e = t; e < NX; e += nt) x[e] = X[NX * k + e];
  for (int e = t; e < NU; e += nt) {
    u[e] = has_u ? U[NU * k + e] : 0.0f;
    zero[e] = 0.0f;
  }
  ld::load_tables(tab, tab_g);  // ends in a barrier
  for (int j = t; j < NQ; j += nt) { s[j] = sinf(x[j]); c[j] = cosf(x[j]); }
  LD_SYNC();

  // ---- three independent recursions, one thread of its own warp each
  if (ld::role(0)) ld::crba(tab, s, c, M);
  if (ld::role(1)) ld::rnea(tab, s, c, x + NQ, zero, grav, bias);
  if (ld::role(2)) ld::fk_ee_jac(tab, s, c, ee, J);
  LD_SYNC();

  // ---- Minv (in place) on warp 0; cost gradient (plant :297-378) on warp 1
  if (ld::in_warp(0)) ld::warp_spd_inverse<NQ>(M);
  if (ld::in_warp(1)) {
    const float e3[3] = {ee[0] - g[0], ee[1] - g[1], ee[2] - g[2]};
    for (int j = ld::lane(); j < NX; j += ld::lanes())
      qg[j] = j < NQ ? J[j] * e3[0] + J[NQ + j] * e3[1] + J[2 * NQ + j] * e3[2]
                     : qd_cost * x[j];
    for (int j = ld::lane(); j < NU; j += ld::lanes()) rg[j] = r_cost * u[j];
  }
  LD_SYNC();

  // ---- qdd = Minv (u - bias); Qr = [[gq gq', 0], [0, qd_cost I]] + rho I
  for (int i = t; i < NQ; i += nt) {
    float acc = 0.0f;
    for (int m = 0; m < NQ; ++m) acc += M[NQ * i + m] * (u[m] - bias[m]);
    qdd[i] = acc;
  }
  for (int e = t; e < NX * NX; e += nt) {
    const int i = e / NX, j = e % NX;
    const float h = (i < NQ && j < NQ) ? qg[i] * qg[j] : (i == j ? qd_cost : 0.0f);
    Q[e] = h + (i == j ? rho : 0.0f);
  }
  LD_SYNC();

  // ---- RNEA primal chain for the tangents; Qinv (in place) on warp 1
  if (ld::role(0)) ld::rnea_primal(tab, s, c, x + NQ, qdd, grav, prim);
  if (ld::in_warp(1)) ld::warp_spd_inverse<NX>(Q);
  LD_SYNC();

  // ---- the 14 tangent directions, one thread each: dtau[i][d]
  for (int d = t; d < NX; d += nt)
    ld::rnea_dtau_direction(tab, s, c, x + NQ, prim, d, dtau + d, NX);
  LD_SYNC();

  // ---- explicit-Euler integrator gradient (integrator.cuh:61-100):
  // A = [[I, dt I], [dt dqdd/dq, I + dt dqdd/dqd]], B = [[0], [dt Minv]],
  // dqdd = -Minv dtau
  for (int e = t; e < NX * NX; e += nt) {
    const int i = e / NX, j = e % NX;
    float a;
    if (i < NQ) {
      a = (j == i ? 1.0f : 0.0f) + (j == NQ + i ? dt : 0.0f);
    } else {
      float acc = 0.0f;
      for (int m = 0; m < NQ; ++m) acc += M[NQ * (i - NQ) + m] * dtau[NX * m + j];
      a = (j == i ? 1.0f : 0.0f) + dt * -acc;
    }
    A[e] = a;
  }
  for (int e = t; e < NX * NU; e += nt) {
    const int i = e / NU, j = e % NU;
    B[e] = i < NQ ? 0.0f : dt * M[NQ * (i - NQ) + j];
  }
  for (int i = t; i < NQ; i += nt) {
    fpred_s[NX * k + i] = x[i] + dt * x[NQ + i];
    fpred_s[NX * k + NQ + i] = x[NQ + i] + dt * qdd[i];
  }
  LD_SYNC();

  // ---- per-knot Schur products (linsys_setup.cuh:141-562)
  for (int e = t; e < NX * NX; e += nt) {
    const int i = e / NX, j = e % NX;
    float acc = 0.0f;
    for (int m = 0; m < NX; ++m) acc += A[NX * i + m] * Q[NX * m + j];
    AQi[e] = acc;
  }
  for (int e = t; e < NX * NU; e += nt) BRi[e] = B[e] * rinv;
  LD_SYNC();

  for (int e = t; e < NX * NX; e += nt) {
    const int i = e / NX, j = e % NX;
    float acc = 0.0f;
    for (int m = 0; m < NX; ++m) acc += AQi[NX * i + m] * A[NX * j + m];
    for (int m = 0; m < NU; ++m) acc += BRi[NU * i + m] * B[NU * j + m];
    const int o = NX * NX * k + e;
    T_s[o] = acc;
    AQi_s[o] = AQi[e];
    Qinv_o[o] = Q[e];
    A_o[o] = has_u ? A[e] : 0.0f;
  }
  for (int i = t; i < NX; i += nt) {
    float qi = 0.0f, tv = 0.0f;
    for (int m = 0; m < NX; ++m) {
      qi += Q[NX * i + m] * qg[m];
      tv += AQi[NX * i + m] * qg[m];
    }
    for (int m = 0; m < NU; ++m) tv += BRi[NU * i + m] * rg[m];
    Qiq_s[NX * k + i] = qi;
    tvec_s[NX * k + i] = tv;
    q_o[NX * k + i] = qg[i];
  }
  for (int e = t; e < NX * NU; e += nt) B_o[NX * NU * k + e] = has_u ? B[e] : 0.0f;
  for (int e = t; e < NU * NU; e += nt)
    Rinv_o[NU * NU * k + e] = (has_u && e % (NU + 1) == 0) ? rinv : 0.0f;
  for (int i = t; i < NU; i += nt) r_o[NU * k + i] = has_u ? rg[i] : 0.0f;
}

LD_GLOBAL void k3_theta(int N, const float* __restrict__ X,
                        const float* __restrict__ Qinv,
                        const float* __restrict__ AQi_s,
                        const float* __restrict__ T_s,
                        const float* __restrict__ tvec_s,
                        const float* __restrict__ Qiq_s,
                        const float* __restrict__ fpred_s, int precond,
                        float* SL, float* SD, float* SU, float* PD,
                        float* gamma) {
  LD_SHARED float theta[NX * NX];
  const int k = LD_BID, t = LD_TID, nt = LD_NTID;
  const int o = NX * NX * k;
  for (int e = t; e < NX * NX; e += nt) {
    const int i = e / NX, j = e % NX;
    theta[e] = Qinv[o + e] + (k >= 1 ? T_s[o - NX * NX + e] : 0.0f);
    SD[o + e] = theta[e];
    SL[o + e] = k >= 1 ? -AQi_s[o - NX * NX + e] : 0.0f;
    SU[o + e] = k <= N - 2 ? -AQi_s[o + NX * j + i] : 0.0f;
  }
  for (int i = t; i < NX; i += nt) {
    const float ck = k >= 1 ? X[NX * k + i] - fpred_s[NX * (k - 1) + i] : 0.0f;
    const float tv = k >= 1 ? tvec_s[NX * (k - 1) + i] : 0.0f;
    gamma[NX * k + i] = Qiq_s[NX * k + i] - tv - ck;
  }
  LD_SYNC();
  if (precond && ld::in_warp(0)) ld::warp_spd_inverse<NX>(theta);
  LD_SYNC();
  for (int e = t; e < NX * NX; e += nt)
    PD[o + e] = precond ? theta[e] : (e % (NX + 1) == 0 ? 1.0f : 0.0f);
}

LD_GLOBAL void k3_stair(int N, const float* __restrict__ SL,
                        const float* __restrict__ SU,
                        const float* __restrict__ PD, int precond, float* PL,
                        float* PU) {
  LD_SHARED float tl[NX * NX], tu[NX * NX];
  const int k = LD_BID, t = LD_TID, nt = LD_NTID;
  const int o = NX * NX * k;
  const bool lo = precond && k >= 1, up = precond && k <= N - 2;
  for (int e = t; e < NX * NX; e += nt) {
    const int i = e / NX, j = e % NX;
    float al = 0.0f, au = 0.0f;
    for (int m = 0; m < NX; ++m) {
      const float p = PD[o + NX * i + m];
      if (lo) al += p * SL[o + NX * m + j];
      if (up) au += p * SU[o + NX * m + j];
    }
    tl[e] = al;
    tu[e] = au;
  }
  LD_SYNC();
  for (int e = t; e < NX * NX; e += nt) {
    const int i = e / NX, j = e % NX;
    float al = 0.0f, au = 0.0f;
    for (int m = 0; m < NX; ++m) {
      if (lo) al += tl[NX * i + m] * PD[o - NX * NX + NX * m + j];
      if (up) au += tu[NX * i + m] * PD[o + NX * NX + NX * m + j];
    }
    PL[o + e] = -al;
    PU[o + e] = -au;
  }
}

}  // namespace

extern "C" int mpc_kkt_schur(const float* tab, int N, const float* X,
                             const float* U, const float* goals, int gstride,
                             const float* rho, float dt, float qd_cost,
                             float r_cost, float grav, int precond,
                             float* SL, float* SD, float* SU, float* PL,
                             float* PD, float* PU, float* gamma, float* Qinv,
                             float* Rinv, float* A, float* B, float* q,
                             float* r, float* AQi_s, float* T_s,
                             float* tvec_s, float* Qiq_s, float* fpred_s,
                             void* stream) {
  LD_LAUNCH(k3_perknot, N, THREADS, 0, stream, tab, N, X, U, goals, gstride,
            rho, dt, qd_cost, r_cost, grav, A, B, Qinv, Rinv, q, r, AQi_s,
            T_s, tvec_s, Qiq_s, fpred_s);
  int err = LD_LAST_ERROR();
  if (err) return err;
  LD_LAUNCH(k3_theta, N, THREADS, 0, stream, N, X, Qinv, AQi_s, T_s, tvec_s,
            Qiq_s, fpred_s, precond, SL, SD, SU, PD, gamma);
  err = LD_LAST_ERROR();
  if (err) return err;
  LD_LAUNCH(k3_stair, N, THREADS, 0, stream, N, SL, SU, PD, precond, PL, PU);
  return LD_LAST_ERROR();
}
