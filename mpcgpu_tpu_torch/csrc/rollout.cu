// K1: plant rollout over one control period, one launch.
//
// Replaces the TPU kernel mpcgpu_tpu/ops/pallas/rollout_kernel.py
// (plant_rollout_pallas / _rollout_kernel).  Explicit Euler in fixed
// sim_step_time substeps (max_substeps of them, inactive ones with dt = 0),
// each with the control active at the simulation clock inside the previous
// plan and ABA forward dynamics, then the fmod remainder substep with the
// control of the last full substep; finally the L1 end-effector xyz error.
//
// Bound on the H100: latency.  The work is one dependent chain of twelve
// ABA evaluations (about 12,000 operations each) on a 14-float state: the
// substeps, and inside each ABA the joints, follow one another, but inside
// each joint the spatial algebra has up to 36 independent outputs (the
// congruence X' Ia X, the rank-1 update, the 6x6 products).  So one warp
// walks an arm's chain with lanedyn.cuh's warp ABA -- every lane one output
// entry, a warp barrier between dependent steps, the tables, state and
// intermediates in shared memory -- and the end-effector FK with its
// prefix products.  No per-thread array is indexed at run time (ptxas's 32
// bytes of stack are sinf/cosf's reduction array for |q| > 105615).  The
// launch itself is a sizeable share of the time.
//
// The arm-batched launch (mpc_rollout_arms) runs B arms' rollouts at once,
// one block (one warp) per arm, each doing exactly what one single launch
// does with the arm's x and U_prev and the shared goal: so B arms cost one
// launch, not B serial ones (the JAX package unrolls B K1 calls).
#include "lanedyn.cuh"

namespace {

constexpr int ARM_THREADS = 32;  // one warp an arm

// Shared state of one arm's rollout: x, sin and cos of q, qdd, the joint
// transforms, the routines' scratch, and the control of this substep (each
// lane loads its entry of the next row while the step runs).
struct Arm {
  float x[ld::NX], s[ld::NJ], c[ld::NJ], qdd[ld::NJ], X[ld::NJ * 36];
  float u[ld::NU];
  float w[ld::ABA_FLOATS > ld::FK_FLOATS ? ld::ABA_FLOATS : ld::FK_FLOATS];
};

LD_FORCE void sincos_q(const ld::Lanes& g, Arm& a) {
  for (int j = g.l; j < ld::NJ; j += g.n) {
    a.s[j] = sinf(a.x[j]);
    a.c[j] = cosf(a.x[j]);
  }
  g.sync();
}

// One explicit-Euler substep of length dt under control u.
LD_FORCE void rollout_step(const ld::Lanes& g, const float* tab, Arm& a,
                           const float* u, float dt, float grav) {
  sincos_q(g, a);
  ld::joint_transforms<ARM_THREADS>(g, tab, a.s, a.c, a.X);
  ld::aba<ARM_THREADS>(g, tab, a.X, a.x + ld::NQ, u, grav, a.qdd, a.w);
  for (int j = g.l; j < ld::NQ; j += g.n) {
    const float q = a.x[j], qd = a.x[ld::NQ + j];
    a.x[j] = q + dt * qd;
    a.x[ld::NQ + j] = qd + dt * a.qdd[j];
  }
  g.sync();
}

LD_FORCE int control_index(float t, float timestep, int n_ctrl) {
  int idx = (int)(t / timestep);
  if (idx < 0) idx = 0;
  if (idx > n_ctrl - 1) idx = n_ctrl - 1;
  return idx;
}

LD_GLOBAL void LD_LAUNCH_BOUNDS(ARM_THREADS)
rollout_kernel(const float* __restrict__ tab_g, const float* __restrict__ x0,
               const float* __restrict__ U_prev, int n_ctrl,
               const float* __restrict__ goal0, float offset_us,
               float sim_time_us, float timestep, float sub, int max_substeps,
               float grav, float* __restrict__ x_out,
               float* __restrict__ err_out) {
  LD_SHARED float tab[ld::TAB_SIZE];
  LD_SHARED Arm a;
  LD_SHARED float ee[3];
  ld::load_tables(tab, tab_g);
  const ld::Lanes g = ld::warp_lanes();
  // block b rolls out arm b
  x0 += ld::NX * LD_BID;
  U_prev += (size_t)ld::NU * n_ctrl * LD_BID;
  x_out += ld::NX * LD_BID;
  err_out += LD_BID;

  const float t0 = offset_us * 1e-6f;
  const float total = sim_time_us * 1e-6f;
  const int n_steps = (int)floorf(total / sub);
  // the remainder substep (st == max_substeps) takes the control of the
  // last full substep
  const int last = n_steps - 1 > 0 ? n_steps - 1 : 0;
  auto row = [&](int st) {
    const float t = t0 + (float)(st < max_substeps ? st : last) * sub;
    return U_prev + ld::NU * control_index(t, timestep, n_ctrl);
  };
  for (int i = g.l; i < ld::NX; i += g.n) a.x[i] = x0[i];
  for (int i = g.l; i < ld::NU; i += g.n) a.u[i] = row(0)[i];
  g.sync();

  for (int st = 0; st <= max_substeps; ++st) {
    const float dt = st < max_substeps ? (st < n_steps ? 1.0f : 0.0f) * sub
                                       : fmodf(total, sub);
    const float un = st < max_substeps && g.l < ld::NU ? row(st + 1)[g.l] : 0.0f;
    if (st < 2) LD_STAMP(20 + 2 * st);
    rollout_step(g, tab, a, a.u, dt, grav);
    if (st < 2) LD_STAMP(21 + 2 * st);
    // rollout_step ends in a barrier: every lane has read a.u
    for (int i = g.l; i < ld::NU; i += g.n)
      a.u[i] = i == g.l ? un : row(st + 1)[i];
    g.sync();
  }

  sincos_q(g, a);
  ld::fk_ee_jac<ARM_THREADS>(g, tab, a.s, a.c, ee, nullptr, a.w);
  for (int i = g.l; i < ld::NX; i += g.n) x_out[i] = a.x[i];
  if (g.l == 0)
    err_out[0] = fabsf(ee[0] - goal0[0]) + fabsf(ee[1] - goal0[1]) +
                 fabsf(ee[2] - goal0[2]);
}

}  // namespace

extern "C" int mpc_rollout_arms(const float* tab, int arms, const float* x0,
                                const float* U_prev, int n_ctrl,
                                const float* goal0, float offset_us,
                                float sim_time_us, float timestep, float sub,
                                int max_substeps, float grav, float* x_out,
                                float* err_out, void* stream) {
  if (arms < 1) return 1;  // cudaErrorInvalidValue
  LD_LAUNCH(rollout_kernel, arms, ARM_THREADS, 0, stream, tab, x0, U_prev, n_ctrl,
            goal0, offset_us, sim_time_us, timestep, sub, max_substeps, grav,
            x_out, err_out);
  return LD_LAST_ERROR();
}

extern "C" int mpc_rollout(const float* tab, const float* x0,
                           const float* U_prev, int n_ctrl,
                           const float* goal0, float offset_us,
                           float sim_time_us, float timestep, float sub,
                           int max_substeps, float grav, float* x_out,
                           float* err_out, void* stream) {
  LD_LAUNCH(rollout_kernel, 1, ARM_THREADS, 0, stream, tab, x0, U_prev, n_ctrl, goal0,
            offset_us, sim_time_us, timestep, sub, max_substeps, grav, x_out,
            err_out);
  return LD_LAST_ERROR();
}
