// K3: KKT linearization, Schur condensation and stair preconditioner.
//
// Replaces the TPU kernels mpcgpu_tpu/ops/pallas/kkt_schur_kernel.py
// (form_kkt_schur_pallas / _kernel -> _perknot) and, for N % 128 == 0,
// form_kkt_schur_tiled (K8: _tile_kernel, _spd_inv_tile_kernel,
// _stair_tile_kernel, the same stages over 128-knot tiles, a Mosaic layout
// workaround): one block per knot has no tile and no N limit.  Knot-major
// outputs:
// S = (SL, SD, SU) and Pinv = (PL, PD, PU) as (N, 14, 14) bands, gamma
// (N, 14), and the blocks primal recovery needs: Qinv (N, 14, 14),
// Rinv (N, 7, 7), A (N, 14, 14), B (N, 14, 7), q (N, 14), r (N, 7), with
// A, B, Rinv and r zero at the last knot (it has no control).
//
// Three launches of one 128-thread block per knot, separated by the launch
// boundaries that the cross-knot terms need (the stage bodies live in
// kkt_schur.cuh, shared with K5):
//   1. per knot: dynamics and their gradient (CRBA, Minv, RNEA bias, the
//      hand-written RNEA tangents, dqdd = -Minv dtau), the integrator's
//      A, B and the predicted state (explicit or semi-implicit Euler, the
//      angle wrap on its positions), the cost gradient and Hessian (eepos
//      with the rank-1 or Gauss-Newton position block, or joint
//      tracking), rho-regularized Q^-1 and R^-1, and the per-knot Schur
//      products A Q^-1, T = A Q^-1 A' + B R^-1 B', Q^-1 q and
//      A Q^-1 q + B R^-1 r into scratch (the knobs: kkt_schur.cuh);
//   2. per knot with its left neighbour: theta, phi (SL), SU, gamma with
//      the defect c_k = x_k - f(x_{k-1}, u_{k-1}) (c_0 left out, as in the
//      reference), and PD = theta^-1;
//   3. per knot with both neighbours: PL = -theta_k^-1 phi_k theta_{k-1}^-1
//      and PU = -theta_k^-1 SU_k theta_{k+1}^-1.
//
// Bound on the H100: latency.  N = 64 knots fill 64 of 132 SMs with one
// block each, and a knot's work is a chain of small dependent steps.  One
// thread per knot (the TPU's lane-per-knot form) spills past 255 registers
// and runs the whole chain serially.  So each knot gets a block, and the
// chain's links are spread over its lanes: the three independent
// recursions (CRBA, RNEA bias, FK + Jacobian) run on three warps at once,
// each warp-cooperative inside a joint (lanedyn.cuh: the 6x6 products, the
// congruence X' A X and the rank-1 update an output entry a lane); warp 0
// then inverts M with a row a lane in registers (the pivot row through a
// small shared buffer), forms qdd and runs the primal RNEA chain while warp 1 forms
// Q and inverts it the same way; the 14 tangent directions run on 8-lane
// groups; and every 14x14 product gives each output entry its own thread.
// The intermediates live in shared memory, one scratch area reused by each
// phase; stage 2 inverts theta in registers too.
#include "kkt_schur.cuh"

namespace {

constexpr int THREADS = 128;

LD_GLOBAL void k3_perknot(const float* tab_g, int N, const float* X,
                          const float* U, const float* goals, int gstride,
                          const float* rho_p, float dt, float qd_cost,
                          float r_cost, float grav, ld::Knobs kn,
                          float* A_o, float* B_o,
                          float* Qinv_o, float* Rinv_o, float* q_o,
                          float* r_o, float* AQi_s, float* T_s,
                          float* tvec_s, float* Qiq_s, float* fpred_s) {
  LD_SHARED float tab[ld::TAB_SIZE];
  ld::load_tables(tab, tab_g);
  k3::perknot(tab, LD_BID, N, X, U, goals, gstride, rho_p, dt, qd_cost,
              r_cost, grav, kn, A_o, B_o, Qinv_o, Rinv_o, q_o, r_o, AQi_s,
              T_s, tvec_s, Qiq_s, fpred_s);
}

LD_GLOBAL void k3_theta(int N, const float* X, const float* Qinv,
                        const float* AQi_s, const float* T_s,
                        const float* tvec_s, const float* Qiq_s,
                        const float* fpred_s, int precond, float* SL,
                        float* SD, float* SU, float* PD, float* gamma) {
  k3::schur_bands(LD_BID, N, X, Qinv, AQi_s, T_s, tvec_s, Qiq_s, fpred_s,
                  precond, SL, SD, SU, PD, gamma);
}

LD_GLOBAL void k3_stair(int N, const float* SL, const float* SU,
                        const float* PD, int precond, float* PL, float* PU) {
  k3::stair(LD_BID, N, SL, SU, PD, precond, PL, PU);
}

}  // namespace

// tracking, hessian, integrator, wrap, q_cost: the knobs (ld::Knobs; 0 the
// defaults: eepos, the reference Hessian, explicit Euler, no wrap); goals'
// rows are gstride floats apart, nx of them under joint tracking.
extern "C" int mpc_kkt_schur(const float* tab, int N, const float* X,
                             const float* U, const float* goals, int gstride,
                             const float* rho, float dt, float qd_cost,
                             float r_cost, float grav, int precond,
                             float* SL, float* SD, float* SU, float* PL,
                             float* PD, float* PU, float* gamma, float* Qinv,
                             float* Rinv, float* A, float* B, float* q,
                             float* r, float* AQi_s, float* T_s,
                             float* tvec_s, float* Qiq_s, float* fpred_s,
                             int tracking, int hessian, int integrator,
                             int wrap, float q_cost, void* stream) {
  ld::Knobs kn;
  if (!ld::make_knobs(tracking, hessian, integrator, wrap, q_cost, &kn))
    return 1;  // cudaErrorInvalidValue
  LD_LAUNCH(k3_perknot, N, THREADS, 0, stream, tab, N, X, U, goals, gstride,
            rho, dt, qd_cost, r_cost, grav, kn, A, B, Qinv, Rinv, q, r, AQi_s,
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

#ifndef __CUDACC__
// Host build only: the device library's warp-cooperative routines, one
// launch of one block each, so that a test holds each against its plain
// version at one lane and, with the block's threads emulated
// (mpc_emu_threads_host), at 32 lanes a warp.  q, qd, qdd, u: (NJ,).
namespace {

struct Knot {
  float s[ld::NJ], c[ld::NJ], X[ld::NJ * 36];
};

LD_DEV void load_knot(const float* tab_g, float* tab, const float* q,
                      Knot& kn) {
  ld::load_tables(tab, tab_g);
  for (int j = LD_TID; j < ld::NJ; j += LD_NTID) {
    kn.s[j] = sinf(q[j]);
    kn.c[j] = cosf(q[j]);
  }
  LD_SYNC();
  ld::joint_transforms(tab, kn.s, kn.c, kn.X, LD_TID, LD_NTID);
  LD_SYNC();
}

LD_GLOBAL void ld_aba_kernel(const float* tab_g, const float* q,
                             const float* qd, const float* u, float grav,
                             float* qdd) {
  LD_SHARED float tab[ld::TAB_SIZE], w[ld::ABA_FLOATS], out[ld::NJ];
  LD_SHARED Knot kn;
  load_knot(tab_g, tab, q, kn);
  ld::aba<32>(ld::warp_lanes(), tab, kn.X, qd, u, grav, out, w);
  for (int j = LD_TID; j < ld::NJ; j += LD_NTID) qdd[j] = out[j];
}

LD_GLOBAL void ld_crba_kernel(const float* tab_g, const float* q, float* M) {
  LD_SHARED float tab[ld::TAB_SIZE], w[ld::CRBA_FLOATS], out[ld::NJ * ld::NJ];
  LD_SHARED Knot kn;
  load_knot(tab_g, tab, q, kn);
  ld::crba<32>(ld::warp_lanes(), tab, kn.X, out, w);
  for (int e = LD_TID; e < ld::NJ * ld::NJ; e += LD_NTID) M[e] = out[e];
}

// tau and the primal chain (RneaPrimal's floats, in its order)
LD_GLOBAL void ld_rnea_kernel(const float* tab_g, const float* q,
                              const float* qd, const float* qdd, float grav,
                              float* tau, float* prim) {
  LD_SHARED float tab[ld::TAB_SIZE], w[ld::RNEA_FLOATS], out[ld::NJ];
  LD_SHARED Knot kn;
  LD_SHARED ld::RneaPrimal P;
  load_knot(tab_g, tab, q, kn);
  ld::rnea<32>(ld::warp_lanes(), tab, kn.X, qd, qdd, grav, P, out, w);
  for (int j = LD_TID; j < ld::NJ; j += LD_NTID) tau[j] = out[j];
  const float* pf = &P.v_in[0][0];
  for (int e = LD_TID; e < (int)(sizeof(P) / sizeof(float)); e += LD_NTID)
    prim[e] = pf[e];
}

LD_GLOBAL void ld_fk_kernel(const float* tab_g, const float* q, float* ee,
                            float* J) {
  LD_SHARED float tab[ld::TAB_SIZE], w[ld::FK_FLOATS], e3[3], j3[3 * ld::NJ];
  LD_SHARED Knot kn;
  load_knot(tab_g, tab, q, kn);
  ld::fk_ee_jac<32>(ld::warp_lanes(), tab, kn.s, kn.c, e3, J ? j3 : nullptr, w);
  for (int e = LD_TID; e < 3 + 3 * ld::NJ; e += LD_NTID) {
    if (e < 3) ee[e] = e3[e];
    else if (J) J[e - 3] = j3[e - 3];
  }
}

// The 2 NJ tangent directions at (q, qd, qdd), 8 lanes each in lockstep,
// as K3 runs them: dtau (NJ, 2 NJ).
LD_GLOBAL void ld_dtau_kernel(const float* tab_g, const float* q,
                              const float* qd, const float* qdd, float grav,
                              float* dtau) {
  LD_SHARED float tab[ld::TAB_SIZE], w[ld::NX * ld::DIR_FLOATS];
  LD_SHARED float out[ld::NJ * ld::NX];
  LD_SHARED Knot kn;
  LD_SHARED ld::RneaPrimal P;
  load_knot(tab_g, tab, q, kn);
  if (ld::in_warp(0))
    ld::rnea<32>(ld::warp_lanes(), tab, kn.X, qd, qdd, grav, P, nullptr, w);
  LD_SYNC();
  const int groups = LD_NTID >= 8 ? LD_NTID / 8 : 1;
  const int dirs = LD_NTID >= 8 ? groups : ld::NX;
  for (int d = LD_TID / 8; d < dirs; d += groups) {
    const int o = d < ld::NX ? d : 0;
    ld::rnea_dtau_direction<8>(ld::group(8, true), tab, kn.X, kn.s, kn.c, qd,
                               P, d, out + o, ld::NX, w + ld::DIR_FLOATS * o);
  }
  LD_SYNC();
  for (int e = LD_TID; e < ld::NJ * ld::NX; e += LD_NTID) dtau[e] = out[e];
}

// reg: the register inverse, else warp_spd_inverse (the shared-memory form)
template <int n>
LD_GLOBAL void ld_inverse_kernel(int reg, float* A) {
  LD_SHARED float a[n * n], buf[2 * n];
  for (int e = LD_TID; e < n * n; e += LD_NTID) a[e] = A[e];
  LD_SYNC();
  if (reg) ld::reg_spd_inverse<n>(a, buf);
  else ld::warp_spd_inverse<n>(a);
  LD_SYNC();
  for (int e = LD_TID; e < n * n; e += LD_NTID) A[e] = a[e];
}

}  // namespace

// With on != 0, every later launch runs each block on as many emulated
// threads as it names (lanedyn.cuh); returns 1 if an emulated barrier timed
// out since the last call (and clears it).
extern "C" int mpc_emu_threads_host(int on) {
  ld_emu_threaded = on != 0;
  return ld_emu_failed.exchange(false) ? 1 : 0;
}

extern "C" int mpc_ld_aba_host(const float* tab, const float* q,
                               const float* qd, const float* u, float grav,
                               float* qdd) {
  LD_LAUNCH(ld_aba_kernel, 1, 32, 0, nullptr, tab, q, qd, u, grav, qdd);
  return 0;
}

extern "C" int mpc_ld_crba_host(const float* tab, const float* q, float* M) {
  LD_LAUNCH(ld_crba_kernel, 1, 32, 0, nullptr, tab, q, M);
  return 0;
}

extern "C" int mpc_ld_rnea_host(const float* tab, const float* q,
                                const float* qd, const float* qdd, float grav,
                                float* tau, float* prim) {
  LD_LAUNCH(ld_rnea_kernel, 1, 32, 0, nullptr, tab, q, qd, qdd, grav, tau,
            prim);
  return 0;
}

extern "C" int mpc_ld_fk_host(const float* tab, const float* q, float* ee,
                              float* J) {
  LD_LAUNCH(ld_fk_kernel, 1, 32, 0, nullptr, tab, q, ee, J);
  return 0;
}

extern "C" int mpc_ld_dtau_host(const float* tab, const float* q,
                                const float* qd, const float* qdd, float grav,
                                float* dtau) {
  LD_LAUNCH(ld_dtau_kernel, 1, THREADS, 0, nullptr, tab, q, qd, qdd, grav,
            dtau);
  return 0;
}

extern "C" int mpc_ld_spd_inverse_host(int n, int reg, float* A) {
  if (n == ld::NQ)
    LD_LAUNCH(ld_inverse_kernel<ld::NQ>, 1, 32, 0, nullptr, reg, A);
  else if (n == ld::NX)
    LD_LAUNCH(ld_inverse_kernel<ld::NX>, 1, 32, 0, nullptr, reg, A);
  else
    return 1;
  return 0;
}
#endif
