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
#include "kkt_schur.cuh"

namespace {

constexpr int THREADS = 128;

LD_GLOBAL void k3_perknot(const float* tab_g, int N, const float* X,
                          const float* U, const float* goals, int gstride,
                          const float* rho_p, float dt, float qd_cost,
                          float r_cost, float grav, float* A_o, float* B_o,
                          float* Qinv_o, float* Rinv_o, float* q_o,
                          float* r_o, float* AQi_s, float* T_s,
                          float* tvec_s, float* Qiq_s, float* fpred_s) {
  LD_SHARED float tab[ld::TAB_SIZE];
  ld::load_tables(tab, tab_g);
  k3::perknot(tab, LD_BID, N, X, U, goals, gstride, rho_p, dt, qd_cost,
              r_cost, grav, A_o, B_o, Qinv_o, Rinv_o, q_o, r_o, AQi_s, T_s,
              tvec_s, Qiq_s, fpred_s);
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
