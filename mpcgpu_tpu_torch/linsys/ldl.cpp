// Sparse LDL' factorization for symmetric quasi-definite systems.
//
// The port's own copy of the host-side oracle of the "qdldl" backend,
// equivalent to the reference's qdldl submodule (osqp/qdldl; call-site API
// at reference include/qdldl/sqp.cuh:44-48,193: etree -> factor -> solve
// on an upper-triangular CSC matrix).  Clean-room implementation of the
// textbook up-looking sparse LDL' algorithm (elimination-tree reach +
// sparse triangular solve per column).
//
// Built at first use by mpcgpu_tpu_torch/linsys/qdldl_host.py:
//   g++ -O2 -shared -fPIC -o mpcgpu_tpu_torch/build/libldl.so ldl.cpp
//
// Matrix format: upper-triangular CSC including the diagonal, column
// pointers Ap (n+1), row indices Ai (sorted ascending within a column),
// values Ax.  All integer arrays are int32.

#include <cstdint>

extern "C" {

// Computes the elimination tree and per-column factor counts.
// work: int scratch of size n.  Returns the total nnz of L (excluding the
// unit diagonal), or -1 if a column has no diagonal entry.
int ldl_etree(int n, const int *Ap, const int *Ai, int *work, int *Lnz,
              int *etree) {
  for (int i = 0; i < n; ++i) {
    work[i] = -1;
    etree[i] = -1;
    Lnz[i] = 0;
  }
  for (int k = 0; k < n; ++k) {
    work[k] = k;  // mark the root so climbs terminate at column k itself
    bool has_diag = false;
    for (int p = Ap[k]; p < Ap[k + 1]; ++p) {
      int i = Ai[p];
      if (i == k) has_diag = true;
      if (i >= k) continue;  // upper triangle: row < column only
      // climb the tree from i until reaching a node already on column k's
      // path, linking new subtrees under k
      while (work[i] != k) {
        if (etree[i] == -1) etree[i] = k;
        ++Lnz[i];  // column i of L gains an entry in row k
        work[i] = k;
        i = etree[i];
      }
    }
    if (!has_diag) return -1;
  }
  int total = 0;
  for (int i = 0; i < n; ++i) total += Lnz[i];
  return total;
}

// Numeric factorization: A = L D L' with unit lower-triangular L.
// Lp must be the exclusive prefix sum of Lnz (size n+1, caller-computed).
// On return Li/Lx hold L's columns (rows ascending per construction),
// D / Dinv the diagonal and its inverse.
// iwork: 3n ints, fwork: n floats, bwork: n bytes (visited marks).
// Returns the number of positive diagonal entries (== n for PD input).
int ldl_factor(int n, const int *Ap, const int *Ai, const float *Ax, int *Lp,
               int *Li, float *Lx, float *D, float *Dinv, const int *Lnz,
               const int *etree, unsigned char *bwork, int *iwork,
               float *fwork) {
  int positive = 0;
  int *n_used = iwork;          // entries written to each L column so far
  int *pattern = iwork + n;     // topological pattern of the current row
  int *stack = iwork + 2 * n;   // etree climb stack
  float *y = fwork;             // dense accumulator for the sparse solve

  for (int i = 0; i < n; ++i) {
    n_used[i] = 0;
    bwork[i] = 0;
    y[i] = 0.0f;
  }

  for (int k = 0; k < n; ++k) {
    // scatter column k of A (rows < k) into y, collect the reach of the
    // elimination tree in topological order into pattern
    int top = n;
    float dk = 0.0f;
    for (int p = Ap[k]; p < Ap[k + 1]; ++p) {
      int i = Ai[p];
      if (i == k) {
        dk = Ax[p];
        continue;
      }
      y[i] = Ax[p];
      int depth = 0;
      while (!bwork[i]) {  // climb until an already-visited node
        stack[depth++] = i;
        bwork[i] = 1;
        i = etree[i];
        if (i == -1 || i >= k) break;
      }
      while (depth > 0) pattern[--top] = stack[--depth];
    }

    // sparse triangular solve L(0:k,0:k) y = A(0:k,k), in topo order
    for (int t = top; t < n; ++t) {
      int j = pattern[t];
      bwork[j] = 0;
      float yj = y[j];
      y[j] = 0.0f;
      float ljk = yj * Dinv[j];
      int p_end = Lp[j] + n_used[j];
      for (int p = Lp[j]; p < p_end; ++p) y[Li[p]] -= Lx[p] * yj;
      // append L[k, j] to column j
      Li[p_end] = k;
      Lx[p_end] = ljk;
      ++n_used[j];
      dk -= ljk * yj;
    }

    D[k] = dk;
    if (dk == 0.0f) return k;  // singular: abort like the reference oracle
    Dinv[k] = 1.0f / dk;
    if (dk > 0.0f) ++positive;
  }
  return positive;
}

// In-place solve of L D L' x = b given the factorization.
void ldl_solve(int n, const int *Lp, const int *Li, const float *Lx,
               const float *Dinv, const int *n_used_unused, float *x) {
  (void)n_used_unused;
  for (int j = 0; j < n; ++j) {  // forward: L z = b
    float xj = x[j];
    for (int p = Lp[j]; p < Lp[j + 1]; ++p) x[Li[p]] -= Lx[p] * xj;
  }
  for (int j = 0; j < n; ++j) x[j] *= Dinv[j];  // D w = z
  for (int j = n - 1; j >= 0; --j) {  // backward: L' x = w
    float acc = x[j];
    for (int p = Lp[j]; p < Lp[j + 1]; ++p) acc -= Lx[p] * x[Li[p]];
    x[j] = acc;
  }
}

}  // extern "C"
