// K3's three stages as per-knot device functions, shared by K3
// (kkt_schur.cu, one launch per stage, one block per knot) and K5
// (sqp_mega.cu, one cooperative launch, grid barriers between the stages).
// See kkt_schur.cu for the math and the design.
//
// A block runs a stage for knot k; every function ends in a block barrier,
// so a block may run the same stage for several knots in turn.  No pointer
// is __restrict__: inside K5 the inputs of a stage were written by other
// blocks earlier in the same launch, which the read-only data path may not
// see.  Stages 1 and 2 are calls, not inlined code: inlined into the
// megakernels (K5, K9p, K5g, K9pg, K10), their warp-cooperative bodies
// raised those kernels' registers to 211-255 a thread, and a count past
// K5's 202 would shrink its co-resident grid.
#pragma once
#include "lanedyn.cuh"

namespace k3 {

constexpr int NX = ld::NX, NU = ld::NU, NQ = ld::NQ;

// Stage 1, per knot: dynamics and their gradient (CRBA, Minv, RNEA bias,
// the hand-written RNEA tangents, dqdd = -Minv dtau), the integrator's A, B
// and the predicted state, the cost gradient and Hessian,
// rho-regularized Q^-1 and R^-1, and the per-knot Schur products
// A Q^-1, T = A Q^-1 A' + B R^-1 B', Q^-1 q and A Q^-1 q + B R^-1 r into
// scratch.  tab: the model tables in shared memory.  The knobs
// (kkt_schur_kernel.py:146-190 of the JAX package, ops/kkt.py here):
//   * tracking: eepos, q = [J'(ee - g), qd_cost qd] with the position block
//     g_q g_q' (hessian 0) or J'J (hessian 1); joint,
//     q = [q_cost (q - g_q), qd_cost (qd - g_qd)] with q_cost I, and no FK;
//   * integrator: explicit Euler, A = [[I, dt I], [dt dqdd/dq, I + dt
//     dqdd/dqd]], B = [[0], [dt Minv]]; semi-implicit, A's top rows
//     [I + dt^2 dqdd/dq, dt I + dt^2 dqdd/dqd], B's dt^2 Minv, and the
//     position predicted from the new velocity;
//   * wrap: the predicted positions wrapped (ld::angle_wrap), never A.
//
// The block's warps: the three recursions (CRBA, RNEA bias, FK + Jacobian;
// no FK under joint tracking) at once, one warp each, lane-parallel inside
// each joint (lanedyn.cuh);
// then warp 0 inverts M in registers, forms qdd and runs the primal RNEA
// chain while warp 1 forms the cost gradient, Q and its register inverse;
// then the NX = 2 NJ tangent directions on 8 lanes each; then the
// products, one output entry a thread.  One shared scratch area serves each
// phase in turn: the largest phase's (the directions' at NJ = 7, the three
// recursions' at NJ = 2).
constexpr int PRIM_FLOATS = (int)(sizeof(ld::RneaPrimal) / sizeof(float));
constexpr int RECUR_FLOATS =
    ld::CRBA_FLOATS + ld::RNEA_FLOATS + ld::FK_FLOATS + PRIM_FLOATS;
constexpr int WORK_FLOATS = NX * ld::DIR_FLOATS > RECUR_FLOATS
                                ? NX * ld::DIR_FLOATS
                                : RECUR_FLOATS;
static_assert(ld::NJ != 7 || WORK_FLOATS == 14 * 96, "the IIWA build's scratch");
static_assert(ld::RNEA_FLOATS + 2 * NQ + 2 * NX <= WORK_FLOATS,
              "the primal chain's scratch and the inverses' buffers");
static_assert(4 * NX * NX + 2 * NX * NU <= WORK_FLOATS, "A, AQi, B, BRi");

LD_NOINLINE void perknot(const float* tab, int k, int N, const float* X,
                         const float* U, const float* goals, int gstride,
                         const float* rho_p, float dt, float qd_cost, float r_cost,
                         float grav, ld::Knobs kn, float* A_o, float* B_o,
                         float* Qinv_o, float* Rinv_o, float* q_o, float* r_o,
                         float* AQi_s, float* T_s, float* tvec_s,
                         float* Qiq_s, float* fpred_s) {
  LD_SHARED float x[NX], u[NU], s[NQ], c[NQ], bias[NQ], qdd[NQ];
  LD_SHARED float M[NQ * NQ], ee[3], J[3 * NQ], qg[NX], rg[NU];
  LD_SHARED float dtau[NQ * NX], Q[NX * NX], Xj[ld::NJ * 36];
  LD_SHARED float work[WORK_FLOATS];
  LD_SHARED ld::RneaPrimal prim;
  const int t = LD_TID, nt = LD_NTID;
  const bool has_u = k < N - 1;
  const float rho = rho_p[0];
  const float rinv = 1.0f / (r_cost + rho);  // R = r_cost I: Rr^-1 is diagonal
  const float* g = goals + gstride * k;

  for (int e = t; e < NX; e += nt) x[e] = X[NX * k + e];
  for (int e = t; e < NU; e += nt) u[e] = has_u ? U[NU * k + e] : 0.0f;
  LD_SYNC();
  for (int j = t; j < NQ; j += nt) { s[j] = sinf(x[j]); c[j] = cosf(x[j]); }
  LD_SYNC();
  ld::joint_transforms(tab, s, c, Xj, t, nt);
  LD_SYNC();
  LD_STAMP(0);

  // ---- the three recursions, a warp each (the bias's chain is scratch)
  const ld::Lanes w = ld::warp_lanes();
  constexpr int W_RNEA = ld::CRBA_FLOATS, W_FK = W_RNEA + ld::RNEA_FLOATS,
                W_PRIM = W_FK + ld::FK_FLOATS;
  // phase 2: warp 0's primal chain at 0, the inverses' pivot-row buffers
  constexpr int W_INV0 = ld::RNEA_FLOATS, W_INV1 = W_INV0 + 2 * NQ;
  if (ld::in_warp(0)) ld::crba<32>(w, tab, Xj, M, work);
  if (ld::in_warp(1))
    ld::rnea<32>(w, tab, Xj, x + NQ, nullptr, grav,
                 *reinterpret_cast<ld::RneaPrimal*>(work + W_PRIM), bias,
                 work + W_RNEA);
  if (ld::in_warp(2) && !kn.tracking)
    ld::fk_ee_jac<32>(w, tab, s, c, ee, J, work + W_FK);
  LD_SYNC();
  LD_STAMP(1);

  // ---- warp 0: Minv (in place), qdd = Minv (u - bias), the primal RNEA
  // chain for the tangents; warp 1: the cost gradient (plant :297-378),
  // Qr = [[Q_pos, 0], [0, qd_cost I]] + rho I and Qinv (in place)
  if (ld::in_warp(0)) {
    ld::reg_spd_inverse<NQ>(M, work + W_INV0);
    for (int i = w.l; i < NQ; i += w.n) {
      float acc = 0.0f;
      for (int m = 0; m < NQ; ++m) acc += M[NQ * i + m] * (u[m] - bias[m]);
      qdd[i] = acc;
    }
    w.sync();
    ld::rnea<32>(w, tab, Xj, x + NQ, qdd, grav, prim, nullptr, work);
  }
  if (ld::in_warp(1)) {
    if (kn.tracking) {
      for (int j = w.l; j < NX; j += w.n)
        qg[j] = (j < NQ ? kn.q_cost : qd_cost) * (x[j] - g[j]);
    } else {
      const float e3[3] = {ee[0] - g[0], ee[1] - g[1], ee[2] - g[2]};
      for (int j = w.l; j < NX; j += w.n)
        qg[j] = j < NQ
                    ? J[j] * e3[0] + J[NQ + j] * e3[1] + J[2 * NQ + j] * e3[2]
                    : qd_cost * x[j];
    }
    for (int j = w.l; j < NU; j += w.n) rg[j] = r_cost * u[j];
    w.sync();
    for (int e = w.l; e < NX * NX; e += w.n) {
      const int i = e / NX, j = e % NX;
      float h;
      if (i < NQ && j < NQ) {
        if (kn.tracking)
          h = i == j ? kn.q_cost : 0.0f;
        else if (kn.hessian)  // J'J
          h = J[i] * J[j] + J[NQ + i] * J[NQ + j] +
              J[2 * NQ + i] * J[2 * NQ + j];
        else
          h = qg[i] * qg[j];
      } else {
        h = i == j ? qd_cost : 0.0f;
      }
      Q[e] = h + (i == j ? rho : 0.0f);
    }
    w.sync();
    ld::reg_spd_inverse<NX>(Q, work + W_INV1);
  }
  LD_SYNC();
  LD_STAMP(2);

  // ---- the NX tangent directions, 8 lanes each, the groups of a warp in
  // lockstep (on the card the groups past NX only keep step): dtau[i][d]
  {
    const ld::Lanes g8 = ld::group(8, true);
    const int groups = nt >= 8 ? nt / 8 : 1, dirs = nt >= 8 ? groups : NX;
    for (int d = t / 8; d < dirs; d += groups) {
      const int o = d < NX ? d : 0;
      ld::rnea_dtau_direction<8>(g8, tab, Xj, s, c, x + NQ, prim, d, dtau + o,
                                 NX, work + ld::DIR_FLOATS * o);
    }
  }
  LD_SYNC();
  LD_STAMP(3);

  float *A = work, *AQi = work + NX * NX, *B = work + 2 * NX * NX,
        *BRi = work + 2 * NX * NX + NX * NU;
  // ---- the integrator's gradient (integrator.cuh:61-100), dqdd =
  // -Minv dtau: explicit Euler, A = [[I, dt I], [dt dqdd/dq, I + dt
  // dqdd/dqd]], B = [[0], [dt Minv]]; semi-implicit Euler, the top rows
  // [I + dt^2 dqdd/dq, dt I + dt^2 dqdd/dqd] and dt^2 Minv
  const bool semi = kn.integrator != 0;
  for (int e = t; e < NX * NX; e += nt) {
    const int i = e / NX, j = e % NX;
    float a;
    if (i < NQ && !semi) {
      a = (j == i ? 1.0f : 0.0f) + (j == NQ + i ? dt : 0.0f);
    } else {
      const int r = i < NQ ? i : i - NQ;
      float acc = 0.0f;
      for (int m = 0; m < NQ; ++m) acc += M[NQ * r + m] * dtau[NX * m + j];
      if (i < NQ)
        a = (j == i ? 1.0f : 0.0f) + (j == NQ + i ? dt : 0.0f) +
            dt * dt * -acc;
      else
        a = (j == i ? 1.0f : 0.0f) + dt * -acc;
    }
    A[e] = a;
  }
  for (int e = t; e < NX * NU; e += nt) {
    const int i = e / NU, j = e % NU;
    B[e] = i < NQ ? (semi ? dt * dt * M[NQ * i + j] : 0.0f)
                  : dt * M[NQ * (i - NQ) + j];
  }
  // the predicted state, its positions wrapped under kn.wrap
  for (int i = t; i < NQ; i += nt) {
    const float qdn = x[NQ + i] + dt * qdd[i];
    float qn = x[i] + dt * (semi ? qdn : x[NQ + i]);
    if (kn.wrap) qn = ld::angle_wrap(qn);
    fpred_s[NX * k + i] = qn;
    fpred_s[NX * k + NQ + i] = qdn;
  }
  LD_SYNC();
  LD_STAMP(4);

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
  LD_STAMP(5);
}

// Stage 2, per knot with its left neighbour: theta, phi (SL), SU, gamma with
// the defect c_k = x_k - f(x_{k-1}, u_{k-1}) (c_0 left out), and PD.
LD_NOINLINE void schur_bands(int k, int N, const float* X, const float* Qinv,
                             const float* AQi_s, const float* T_s,
                             const float* tvec_s, const float* Qiq_s,
                             const float* fpred_s, int precond, float* SL,
                             float* SD, float* SU, float* PD, float* gamma) {
  LD_SHARED float theta[NX * NX], inv_buf[2 * NX];
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
  if (precond && ld::in_warp(0)) ld::reg_spd_inverse<NX>(theta, inv_buf);
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
