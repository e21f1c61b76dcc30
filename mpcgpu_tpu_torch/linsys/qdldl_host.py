"""The host sparse LDL' oracle, the "qdldl" linsys backend (counterpart of
mpcgpu_tpu/linsys/qdldl_host.py; the reference's QDLDL path,
include/qdldl/sqp.cuh:23-48 qdldl_solve_schur).

Each SQP iteration copies S's diagonal and upper bands and gamma to the
host in one transfer, factors S = L D L' and solves there with the port's
own copy of an up-looking sparse LDL' (linsys/ldl.cpp, built with g++ into
mpcgpu_tpu_torch/build/libldl.so at first use), and copies lam back.  On
a CUDA tensor that is one device-to-host read per SQP iteration, by
design: this backend is the reference's CPU baseline, not a device path.
A failed build raises; there is no other solver behind it.  An indefinite
or singular factor returns NaNs, as the JAX package's does.

The sparsity is the fixed upper triangle of the block-tridiagonal Schur
complement: nnz = N s (s+1)/2 + (N-1) s^2 (reference include/utils/csr.cuh
and qdldl/sqp.cuh:148).  Its pattern and the band->CSC gather are built
once per (N, s); the symbolic analysis (elimination tree, column counts)
runs once per solver, as the reference's one-time QDLDL_etree.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

_SRC = Path(__file__).resolve().parent / "ldl.cpp"
BUILD = Path(__file__).resolve().parents[1] / "build"
_LIB = BUILD / "libldl.so"

_libs: dict = {}


def build() -> Path:
    """Compile linsys/ldl.cpp with the host C++ compiler ($CXX, else g++)
    if the library is missing or stale; return its path.  Raises if it
    cannot."""
    if _LIB.exists() and _LIB.stat().st_mtime >= _SRC.stat().st_mtime:
        return _LIB
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no host C++ compiler found: the qdldl backend's "
                           "LDL' library cannot be built")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
    cmd = [cxx, "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building the LDL' library failed: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the LDL' library failed ({cxx}, rc "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, _LIB)
    return _LIB


def library() -> ctypes.CDLL:
    """The bound LDL' library (built at first use)."""
    if "ldl" not in _libs:
        lib = ctypes.CDLL(str(build()))
        i32p = ctypes.POINTER(ctypes.c_int32)
        f32p = ctypes.POINTER(ctypes.c_float)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.ldl_etree.restype = ctypes.c_int
        lib.ldl_etree.argtypes = [ctypes.c_int, i32p, i32p, i32p, i32p, i32p]
        lib.ldl_factor.restype = ctypes.c_int
        lib.ldl_factor.argtypes = [ctypes.c_int, i32p, i32p, f32p, i32p, i32p,
                                   f32p, f32p, f32p, i32p, i32p, u8p, i32p,
                                   f32p]
        lib.ldl_solve.restype = None
        lib.ldl_solve.argtypes = [ctypes.c_int, i32p, i32p, f32p, f32p, i32p,
                                  f32p]
        _libs["ldl"] = lib
    return _libs["ldl"]


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _bptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


@lru_cache(maxsize=8)
def _btd_pattern(n: int, s: int):
    """(Ap, Ai, take) of the upper-triangular CSC of an (N s)^2
    block-tridiagonal matrix: column j of block k holds the upper-block
    entries of block row k-1 (all s rows, k > 0), then the diagonal-block
    entries with row <= j, rows ascending; take indexes each value in
    concat(upper.ravel(), diag.ravel())."""
    ap, ai, take = [0], [], []
    for k in range(n):
        for cj in range(s):
            if k > 0:
                ai.extend(range((k - 1) * s, k * s))
                take.extend(((k - 1) * s + i) * s + cj for i in range(s))
            ai.extend(range(k * s, k * s + cj + 1))
            take.extend(n * s * s + (k * s + i) * s + cj
                        for i in range(cj + 1))
            ap.append(len(ai))
    return (np.asarray(ap, np.int32), np.asarray(ai, np.int32),
            np.asarray(take, np.int64))


def _btd_upper_csc(lower, diag, upper):
    """Upper-triangular CSC (Ap, Ai, Ax) of a block-tridiagonal matrix
    (bands (N, s, s) as numpy arrays; lower is not read)."""
    n, s, _ = np.shape(diag)
    Ap, Ai, take = _btd_pattern(n, s)
    src = np.concatenate([np.asarray(upper, np.float32).reshape(-1),
                          np.asarray(diag, np.float32).reshape(-1)])
    return Ap, Ai, src[take]


class LDLSolver:
    """Factor / solve S x = b for the block-tridiagonal Schur complement."""

    def __init__(self, n_blocks: int, block_size: int):
        self.n, self.s = n_blocks, block_size
        self.dim = n_blocks * block_size
        self.lib = library()
        self._sym = None

    def _symbolic(self, Ap, Ai):
        dim = self.dim
        work = np.zeros(dim, np.int32)
        Lnz = np.zeros(dim, np.int32)
        etree = np.zeros(dim, np.int32)
        total = self.lib.ldl_etree(dim, _iptr(Ap), _iptr(Ai), _iptr(work),
                                   _iptr(Lnz), _iptr(etree))
        if total < 0:
            raise ValueError("the matrix has a column without its diagonal "
                             "entry")
        Lp = np.zeros(dim + 1, np.int32)
        np.cumsum(Lnz, out=Lp[1:])
        self._sym = (Lnz, etree, Lp, total)

    def solve(self, lower, diag, upper, b):
        """x (shaped as b) from S's bands (numpy, (N, s, s))."""
        return self.solve_csc(*_btd_upper_csc(lower, diag, upper), b)

    def solve_csc(self, Ap, Ai, Ax, b):
        """Numeric factor + solve on a pre-assembled upper CSC pattern: the
        part the reference's TIME_LINSYS brackets, apart from the host
        assembly."""
        x = np.asarray(b, np.float32).reshape(-1).copy()
        if self._sym is None:
            self._symbolic(Ap, Ai)
        Lnz, etree, Lp, total = self._sym
        dim = self.dim
        Li = np.zeros(max(total, 1), np.int32)
        Lx = np.zeros(max(total, 1), np.float32)
        D = np.zeros(dim, np.float32)
        Dinv = np.zeros(dim, np.float32)
        bwork = np.zeros(dim, np.uint8)
        iwork = np.zeros(3 * dim, np.int32)
        fwork = np.zeros(dim, np.float32)
        ok = self.lib.ldl_factor(
            dim, _iptr(Ap), _iptr(Ai), _fptr(Ax), _iptr(Lp), _iptr(Li),
            _fptr(Lx), _fptr(D), _fptr(Dinv), _iptr(Lnz), _iptr(etree),
            _bptr(bwork), _iptr(iwork), _fptr(fwork))
        if ok < dim:  # indefinite or singular: NaNs, like a failed solve
            return np.full(np.shape(b), np.nan, np.float32)
        self.lib.ldl_solve(dim, _iptr(Lp), _iptr(Li), _fptr(Lx), _fptr(Dinv),
                           _iptr(iwork), _fptr(x))
        return x.reshape(np.shape(b))


@lru_cache(maxsize=8)
def _cached_solver(n_blocks: int, block_size: int) -> LDLSolver:
    return LDLSolver(n_blocks, block_size)


def solve_linsys_qdldl(cfg, schur, lam, pcg_exit_tol):
    """The "qdldl" backend: fn(cfg, schur, lam, tol) -> (lam, iters 0,
    hit False), S's bands and gamma through the host (module doc)."""
    n, s = schur.gamma.shape
    nb = n * s * s
    host = torch.cat([schur.S.diag.reshape(-1), schur.S.upper.reshape(-1),
                      schur.gamma.reshape(-1)]).to("cpu", torch.float32)
    host = host.numpy()
    x = _cached_solver(n, s).solve(None, host[:nb].reshape(n, s, s),
                                   host[nb:2 * nb].reshape(n, s, s),
                                   host[2 * nb:].reshape(n, s))
    dev = schur.gamma.device
    return (torch.from_numpy(x).to(dev, schur.gamma.dtype),
            torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev))
