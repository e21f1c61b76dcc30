// The merit contribution of one knot of one line-search candidate, on a
// group of lanes, shared by K2 (merit.cu) and the line-search stage of the
// megakernels (sqp_mega.cu, sqp_mega_packed.cu):
//
//   J_k + mu * (||x_{k+1} - f(x_k, u_k)||_1 [k < N-1] + ||x_0 - xs||_1 [k = 0])
//
// with the eepos tracking cost J_k and explicit-Euler ABA dynamics f, at the
// candidate (X, U) + alpha (dX, dU).  The group (ld::Lanes, G lanes of one
// warp, its warp's groups in lockstep) stages the candidate's rows with sin
// and cos of q in its shared area, forms the joint transforms beside
// fk_ee_jac's end-effector position, runs ld::aba for qdd, and then every
// lane sums the costs, the L1 defects and the x0 term in the term order of a
// one-thread sum.  At G = 32 a contribution has the bits of a one-thread
// FK + ABA chain; at G = 8 and 16 the compiler pairs a few of ABA's
// multiply-adds otherwise (pA, pa: a last-place difference that reaches
// qdd; tools/phase_bench.cu's bits_k2).  The last
// knot runs ABA too (on u = 0, its defect left out), so that every group of
// a warp takes the same steps.
//
// contribs spreads the (arm, candidate, knot) triples of a launch over the
// groups of every block of the grid.
#pragma once
#include "lanedyn.cuh"

namespace k2 {

constexpr int NX = ld::NX, NU = ld::NU, NQ = ld::NQ, NJ = ld::NJ;

// A group's shared area: the candidate's x_k, x_{k+1} and u_k, sin and cos
// of q_k (in that order, as the loading step writes them), the end-effector
// position, qdd, the joint transforms, and the routines' scratch (FK's,
// then ABA's).
constexpr int A_X = 0, A_XN = A_X + NX, A_U = A_XN + NX, A_S = A_U + NU,
              A_C = A_S + NJ, A_EE = A_C + NJ, A_QDD = A_EE + 3, A_XJ = 60,
              A_W = A_XJ + NJ * 36;
constexpr int W_FLOATS =
    ld::FK_FLOATS > ld::ABA_FLOATS ? ld::FK_FLOATS : ld::ABA_FLOATS;
constexpr int AREA_FLOATS = A_W + W_FLOATS;  // 724
static_assert(A_QDD + NJ <= A_XJ, "the area's layout");

// Shared floats of a block of `threads` threads whose groups have G lanes.
LD_HD int areas_floats(int threads, int G) {
  return (threads >= G ? threads / G : 1) * AREA_FLOATS;
}

// The contribution of knot k of the candidate (X, U) + alpha (dX, dU) --
// (X, U) itself when dX and dU are null -- over N knots: X, dX (N, NX),
// U (N-1, NU), dU (N, NU) rows; g the knot's goal, xs the start state.
// Every lane of the group calls it and gets the contribution.
template <int G>
LD_FORCE float merit_contrib(const ld::Lanes& grp, const float* tab,
                             float* area, const float* X, const float* dX,
                             const float* U, const float* dU, int k, int N,
                             float alpha, const float* g, const float* xs,
                             float dt, float mu, float qd_cost, float r_cost,
                             float grav) {
  const bool has_u = k < N - 1, first = k == 0;
  float *x = area + A_X, *xn = area + A_XN, *u = area + A_U, *s = area + A_S,
        *c = area + A_C, *ee = area + A_EE, *qdd = area + A_QDD,
        *Xj = area + A_XJ, *w = area + A_W;
  LD_STAMP(30);
  // x_k, x_{k+1}, u_k (zero past the last knot), sin q_k, cos q_k
  ld::each<G, 2 * NX + NU + 2 * NJ>(
      grp,
      [&](int e) {
        auto cand = [&](const float* V, const float* dV, int i) {
          return dV ? V[i] + alpha * dV[i] : V[i];
        };
        if (e < NX) return cand(X, dX, NX * k + e);
        if (e < 2 * NX) return has_u ? cand(X, dX, NX * (k + 1) + e - NX) : 0.0f;
        if (e < A_S) return has_u ? cand(U, dU, NU * k + e - A_U) : 0.0f;
        const int j = (e - A_S) % NJ;
        const float q = cand(X, dX, NX * k + j);
        return e < A_C ? sinf(q) : cosf(q);
      },
      [&](int e, float v) { area[e] = v; });
  grp.sync();
  LD_STAMP(31);
  // the joint transforms, stored while FK forms its own (FK does not read
  // them), then the end-effector position
  ld::each<G, NJ * 36>(
      grp,
      [&](int e) {
        const int j = e / 36;
        return tab[ld::TAB_XC + e] + s[j] * tab[ld::TAB_XS + e] +
               c[j] * tab[ld::TAB_XK + e];
      },
      [&](int e, float v) { Xj[e] = v; });
  ld::fk_ee_jac<G>(grp, tab, s, c, ee, nullptr, w);
  LD_STAMP(32);
  ld::aba<G>(grp, tab, Xj, x + NQ, u, grav, qdd, w);
  LD_STAMP(33);

  float e2 = 0.0f, qd2 = 0.0f, u2 = 0.0f;
  for (int i = 0; i < 3; ++i) e2 += (ee[i] - g[i]) * (ee[i] - g[i]);
  for (int i = 0; i < NQ; ++i) qd2 += x[NQ + i] * x[NQ + i];
  for (int i = 0; i < NU; ++i) u2 += u[i] * u[i];
  float cost = 0.5f * e2 + 0.5f * qd_cost * qd2;
  if (has_u) cost += 0.5f * r_cost * u2;
  float defect = 0.0f;
  if (has_u)
    for (int j = 0; j < NQ; ++j) {
      defect += fabsf(xn[j] - (x[j] + dt * x[NQ + j]));
      defect += fabsf(xn[NQ + j] - (x[NQ + j] + dt * qdd[j]));
    }
  float c0 = 0.0f;
  if (first)
    for (int i = 0; i < NX; ++i) c0 += fabsf(x[i] - xs[i]);
  const float out = cost + mu * (defect + c0);
  grp.sync();  // every lane has read the area before the group's next pair
  LD_STAMP(34);
  return out;
}

// The (arm, candidate, knot) triples of one launch: B arms of NC candidates
// of N knots.  Candidate c < stepped is at alpha = 1/2^c, a later one at
// alpha = 0; dX and dU null: no step.  Arm a's rows start at X + NX N a,
// dX + NX N a, U + NU (N-1) a, dU + NU N a, goals + garm a, xs + NX a;
// triple (a, c, k)'s contribution goes to contrib[cstride a + N c + k].
struct Job {
  const float *X, *dX, *U, *dU, *goals, *xs;
  float* contrib;
  int N, B, NC, stepped, gstride, garm, cstride;
  float dt, mu, qd_cost, r_cost, grav;
};

// Every triple of job j, spread over the groups of G lanes of the grid's
// blocks: in pass q, group l of block b takes triple q T + l nb + b (T
// groups in all, nb blocks), so a pass spreads over every block before it
// fills one.  A group past the last triple repeats it without storing (its
// warp keeps step), and a warp with none left stops.  areas:
// areas_floats(LD_NTID, G) shared floats.  Ends in a group barrier, not a
// block barrier.
template <int G>
LD_NOINLINE void contribs(const float* tab, float* areas, Job j) {
  const int nt = LD_NTID, t = LD_TID, nb = LD_NBID, bid = LD_BID;
  const int per_block = nt >= G ? nt / G : 1, l = nt >= G ? t / G : 0;
  const int warp_first = nt >= G ? (t & ~31) / G : 0;
  const int per_arm = j.NC * j.N, total = j.B * per_arm;
  const ld::Lanes grp = ld::group(G, true);
  float* area = areas + AREA_FLOATS * l;
  for (int base = 0; base + warp_first * nb + bid < total;
       base += per_block * nb) {
    const int pp = base + l * nb + bid, live = pp < total;
    const int tr = live ? pp : total - 1;
    const int a = tr / per_arm, c = (tr / j.N) % j.NC, k = tr % j.N;
    const float alpha = c < j.stepped ? 1.0f / (float)(1 << c) : 0.0f;
    const size_t xa = (size_t)NX * j.N * a, ua = (size_t)NU * a;
    const float v = merit_contrib<G>(
        grp, tab, area, j.X + xa, j.dX ? j.dX + xa : nullptr,
        j.U + ua * (j.N - 1), j.dU ? j.dU + ua * j.N : nullptr, k, j.N, alpha,
        j.goals + (size_t)j.garm * a + j.gstride * k, j.xs + NX * a, j.dt,
        j.mu, j.qd_cost, j.r_cost, j.grav);
    if (live && grp.l == 0) j.contrib[(size_t)j.cstride * a + j.N * c + k] = v;
  }
}

// The group size of a launch of `blocks` blocks of `threads` threads over
// `triples` triples: the fewest passes, and among those the widest group
// (a contribution's steps are shorter on more lanes; at N = 64, 256 and 512
// on K5's grids this is the fastest of 8, 16 and 32, tools/phase_bench.cu).
LD_HD int group_for(int triples, int blocks, int threads) {
  const int sizes[3] = {32, 16, 8};
  int best = 32, passes = 1 << 30;
  for (int G : sizes) {
    const long long groups =
        (long long)blocks * (threads >= G ? threads / G : 1);
    const int p = (int)((triples + groups - 1) / groups);
    if (p < passes) {
      passes = p;
      best = G;
    }
  }
  return best;
}

// contribs at the group size G (8, 16 or 32).  A timing tool may define
// LD_MERIT_GROUP(G) to choose another (tools/phase_bench.cu).
LD_DEV void contribs_at(int G, const float* tab, float* areas, const Job& j) {
#ifdef LD_MERIT_GROUP
  G = LD_MERIT_GROUP(G);
#endif
  if (G == 32)
    contribs<32>(tab, areas, j);
  else if (G == 16)
    contribs<16>(tab, areas, j);
  else
    contribs<8>(tab, areas, j);
}

}  // namespace k2
