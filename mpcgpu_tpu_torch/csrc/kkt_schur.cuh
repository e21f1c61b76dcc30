// K3's three stages as per-knot device functions, shared by K3
// (kkt_schur.cu, one launch per stage, one block per knot) and K5
// (sqp_mega.cu, one cooperative launch, grid barriers between the stages).
// See kkt_schur.cu for the math and the design.
//
// A block runs a stage for knot k; every function ends in a block barrier,
// so a block may run the same stage for several knots in turn.  No pointer
// is __restrict__: inside K5 the inputs of a stage were written by other
// blocks earlier in the same launch, which the read-only data path may not
// see.
#pragma once
#include "lanedyn.cuh"

namespace k3 {

constexpr int NX = ld::NX, NU = ld::NU, NQ = ld::NQ;

// Stage 1, per knot: dynamics and their gradient (CRBA, Minv, RNEA bias,
// the hand-written RNEA tangents, dqdd = -Minv dtau), explicit-Euler A, B
// and the predicted state, the eepos cost gradient and rank-1 Hessian,
// rho-regularized Q^-1 and R^-1, and the per-knot Schur products
// A Q^-1, T = A Q^-1 A' + B R^-1 B', Q^-1 q and A Q^-1 q + B R^-1 r into
// scratch.  tab: the model tables in shared memory.
LD_DEV void perknot(const float* tab, int k, int N, const float* X,
                    const float* U, const float* goals, int gstride,
                    const float* rho_p, float dt, float qd_cost, float r_cost,
                    float grav, float* A_o, float* B_o, float* Qinv_o,
                    float* Rinv_o, float* q_o, float* r_o, float* AQi_s,
                    float* T_s, float* tvec_s, float* Qiq_s, float* fpred_s) {
  LD_SHARED float x[NX], u[NU], s[NQ], c[NQ], zero[NQ], bias[NQ], qdd[NQ];
  LD_SHARED float M[NQ * NQ], ee[3], J[3 * NQ], qg[NX], rg[NU];
  LD_SHARED float dtau[NQ * NX], A[NX * NX], B[NX * NU], Q[NX * NX];
  LD_SHARED float AQi[NX * NX], BRi[NX * NU];
  LD_SHARED ld::RneaPrimal prim;
  const int t = LD_TID, nt = LD_NTID;
  const bool has_u = k < N - 1;
  const float rho = rho_p[0];
  const float rinv = 1.0f / (r_cost + rho);  // R = r_cost I: Rr^-1 is diagonal
  const float* g = goals + gstride * k;

  for (int e = t; e < NX; e += nt) x[e] = X[NX * k + e];
  for (int e = t; e < NU; e += nt) {
    u[e] = has_u ? U[NU * k + e] : 0.0f;
    zero[e] = 0.0f;
  }
  LD_SYNC();
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
  LD_SYNC();  // the shared arrays are reused by the block's next knot
}

// Stage 2, per knot with its left neighbour: theta, phi (SL), SU, gamma with
// the defect c_k = x_k - f(x_{k-1}, u_{k-1}) (c_0 left out), and PD.
LD_DEV void schur_bands(int k, int N, const float* X, const float* Qinv,
                        const float* AQi_s, const float* T_s,
                        const float* tvec_s, const float* Qiq_s,
                        const float* fpred_s, int precond, float* SL,
                        float* SD, float* SU, float* PD, float* gamma) {
  LD_SHARED float theta[NX * NX];
  const int t = LD_TID, nt = LD_NTID;
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
  LD_SYNC();
}

// Stage 3, per knot with both neighbours: PL and PU.
LD_DEV void stair(int k, int N, const float* SL, const float* SU,
                  const float* PD, int precond, float* PL, float* PU) {
  LD_SHARED float tl[NX * NX], tu[NX * NX];
  const int t = LD_TID, nt = LD_NTID;
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
  LD_SYNC();
}

}  // namespace k3
