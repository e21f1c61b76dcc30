// K1: plant rollout over one control period, one launch.
//
// Replaces the TPU kernel mpcgpu_tpu/ops/pallas/rollout_kernel.py
// (plant_rollout_pallas / _rollout_kernel).  Explicit Euler in fixed
// sim_step_time substeps (max_substeps of them, inactive ones with dt = 0),
// each with the control active at the simulation clock inside the previous
// plan and ABA forward dynamics, then the fmod remainder substep with the
// control of the last full substep; finally the L1 end-effector xyz error.
//
// Bound on the H100: pure latency.  The work is one dependent chain of
// twelve ABA evaluations (a few thousand flops each) on a 14-float state,
// so no parallel decomposition helps; a single block runs it, its threads
// first copying the model tables into shared memory, and thread 0 walks the
// chain in registers and local memory.  The launch itself is a sizeable
// share of the time.
#include "lanedyn.cuh"

namespace {

LD_DEV void rollout_step(const float* tab, float* x, const float* u, float dt,
                         float grav) {
  float s[ld::NJ], c[ld::NJ], qdd[ld::NJ];
  for (int j = 0; j < ld::NJ; ++j) { s[j] = sinf(x[j]); c[j] = cosf(x[j]); }
  ld::aba_qdd(tab, s, c, x + ld::NQ, u, grav, qdd);
  float xn[ld::NX];
  for (int j = 0; j < ld::NQ; ++j) {
    xn[j] = x[j] + dt * x[ld::NQ + j];
    xn[ld::NQ + j] = x[ld::NQ + j] + dt * qdd[j];
  }
  for (int i = 0; i < ld::NX; ++i) x[i] = xn[i];
}

LD_DEV int control_index(float t, float timestep, int n_ctrl) {
  int idx = (int)(t / timestep);
  if (idx < 0) idx = 0;
  if (idx > n_ctrl - 1) idx = n_ctrl - 1;
  return idx;
}

LD_GLOBAL void rollout_kernel(const float* __restrict__ tab_g,
                              const float* __restrict__ x0,
                              const float* __restrict__ U_prev, int n_ctrl,
                              const float* __restrict__ goal0,
                              float offset_us, float sim_time_us,
                              float timestep, float sub, int max_substeps,
                              float grav, float* __restrict__ x_out,
                              float* __restrict__ err_out) {
  LD_SHARED float tab[ld::TAB_SIZE];
  ld::load_tables(tab, tab_g);
  if (LD_TID != 0) return;

  const float t0 = offset_us * 1e-6f;
  const float total = sim_time_us * 1e-6f;
  const int n_steps = (int)floorf(total / sub);
  float x[ld::NX];
  for (int i = 0; i < ld::NX; ++i) x[i] = x0[i];

  for (int st = 0; st < max_substeps; ++st) {
    const float active = st < n_steps ? 1.0f : 0.0f;
    const float t = t0 + (float)st * sub;
    const float* u = U_prev + ld::NU * control_index(t, timestep, n_ctrl);
    rollout_step(tab, x, u, active * sub, grav);
  }
  // remainder with the control of the last full substep
  const float rem = fmodf(total, sub);
  const int last = n_steps - 1 > 0 ? n_steps - 1 : 0;
  const float t_last = t0 + (float)last * sub;
  rollout_step(tab, x, U_prev + ld::NU * control_index(t_last, timestep, n_ctrl),
               rem, grav);

  float s[ld::NJ], c[ld::NJ], ee[3];
  for (int j = 0; j < ld::NJ; ++j) { s[j] = sinf(x[j]); c[j] = cosf(x[j]); }
  ld::fk_ee(tab, s, c, ee);
  for (int i = 0; i < ld::NX; ++i) x_out[i] = x[i];
  err_out[0] = fabsf(ee[0] - goal0[0]) + fabsf(ee[1] - goal0[1]) +
               fabsf(ee[2] - goal0[2]);
}

}  // namespace

extern "C" int mpc_rollout(const float* tab, const float* x0,
                           const float* U_prev, int n_ctrl,
                           const float* goal0, float offset_us,
                           float sim_time_us, float timestep, float sub,
                           int max_substeps, float grav, float* x_out,
                           float* err_out, void* stream) {
  LD_LAUNCH(rollout_kernel, 1, 32, 0, stream, tab, x0, U_prev, n_ctrl, goal0,
            offset_us, sim_time_us, timestep, sub, max_substeps, grav, x_out,
            err_out);
  return LD_LAST_ERROR();
}
