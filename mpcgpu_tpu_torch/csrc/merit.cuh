// The merit contribution of one knot of one line-search candidate, shared
// by K2 (merit.cu) and K5 (sqp_mega.cu, its line-search stage):
//
//   J_k + mu * (||x_{k+1} - f(x_k, u_k)||_1 [k < N-1] + ||x_0 - xs||_1 [k = 0])
//
// with the eepos tracking cost J_k and explicit-Euler ABA dynamics f.  x, xn
// and u are the candidate's state at knots k and k+1 and its control at
// knot k (any memory); tab is the model tables in shared memory.
#pragma once
#include "lanedyn.cuh"

namespace k2 {

LD_DEV float merit_contrib(const float* tab, const float* x, const float* xn,
                           const float* u, bool has_u, bool first,
                           const float* g, const float* xs, float dt,
                           float mu, float qd_cost, float r_cost,
                           float grav) {
  float s[ld::NJ], c[ld::NJ], ee[3];
  for (int j = 0; j < ld::NJ; ++j) { s[j] = sinf(x[j]); c[j] = cosf(x[j]); }
  ld::fk_ee(tab, s, c, ee);
  float e2 = 0.0f, qd2 = 0.0f, u2 = 0.0f;
  for (int i = 0; i < 3; ++i) e2 += (ee[i] - g[i]) * (ee[i] - g[i]);
  for (int i = 0; i < ld::NQ; ++i) qd2 += x[ld::NQ + i] * x[ld::NQ + i];
  for (int i = 0; i < ld::NU; ++i) u2 += u[i] * u[i];
  float cost = 0.5f * e2 + 0.5f * qd_cost * qd2;
  if (has_u) cost += 0.5f * r_cost * u2;

  float defect = 0.0f;
  if (has_u) {
    float qdd[ld::NJ];
    ld::aba_qdd(tab, s, c, x + ld::NQ, u, grav, qdd);
    for (int j = 0; j < ld::NQ; ++j) {
      defect += fabsf(xn[j] - (x[j] + dt * x[ld::NQ + j]));
      defect += fabsf(xn[ld::NQ + j] - (x[ld::NQ + j] + dt * qdd[j]));
    }
  }
  float c0 = 0.0f;
  if (first)
    for (int i = 0; i < ld::NX; ++i) c0 += fabsf(x[i] - xs[i]);
  return cost + mu * (defect + c0);
}

}  // namespace k2
