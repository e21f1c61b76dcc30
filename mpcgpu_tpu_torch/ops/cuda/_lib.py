"""Build and bind the hand-written CUDA kernels of ``csrc/``.

All kernels build with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface per joint count (``-DMPC_NJ=<nj>``, csrc/
lanedyn.cuh): ``mpcgpu_tpu_torch/build/libmpcgpu_kernels.so`` for the
7-joint IIWA, ``libmpcgpu_kernels_nj<nj>.so`` for another count, each at
its first use, and again whenever a source is newer than the library: one
``nvcc -c`` per source, all started together, then one link.  A count
other than 7 builds only ``NJ_SOURCES``, the kernels that serve it (K1-K5
and the forms of K4 and K5 past their fits); the wrappers of the others
raise for it by name (``require_iiwa``).  The library is bound with
``ctypes``: pointers and the stream pass as ``c_void_p``, and every entry
returns ``cudaGetLastError()``.

The same sources also build with the host C++ compiler
(``host_library``): a kernel "launch" then runs every block in turn on
the calling thread, on CPU memory, or -- once a test has switched the
emulation on (``mpc_emu_threads_host``) -- on as many host threads as the
launch names, with real barriers; K10's cluster form, and the cluster
form of K4 and K4b and the joined forms (K5g, K9pg, K4g, K4bg) on more
than one block, run their blocks one after another between the grid and
cluster barriers and the waits on tagged words, each on a host thread of
its own (lanedyn.cuh's block emulation).  That build exists to check the kernels' arithmetic against
the plain PyTorch versions on a machine without a GPU.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import weakref
from pathlib import Path
from typing import NamedTuple

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"
SOURCES = ("rollout.cu", "merit.cu", "kkt_schur.cu", "pcg_dz.cu",
           "bcr_pcg_dz.cu", "bcr_dz.cu", "sqp_mega.cu", "sqp_mega_packed.cu",
           "spmv_halo.cu")
HEADERS = ("lanedyn.cuh", "kkt_schur.cuh", "merit.cuh", "pcg_common.cuh",
           "bcr_common.cuh")
IIWA_NJ = 7
# the sources a joint count other than IIWA_NJ builds
NJ_SOURCES = ("rollout.cu", "merit.cu", "kkt_schur.cu", "pcg_dz.cu",
              "sqp_mega.cu")
MIN_NJ, MAX_NJ = 2, 7
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_KNOBS = [_I, _I, _I, _I, _F]  # knob_args
_SIGNATURES = {
    "mpc_rollout": [_P, _P, _P, _I, _P, _F, _F, _F, _F, _I, _F, _P, _P, _P],
    "mpc_rollout_arms": [_P, _I, _P, _P, _I, _P, _F, _F, _F, _F, _I, _F, _P,
                         _P, _P],
    "mpc_merits": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _F, _F, _F, _F,
                   _F, _P, _P, _I, _P] + _KNOBS + [_P],
    "mpc_kkt_schur": [_P, _I, _P, _P, _P, _I, _P, _F, _F, _F, _F, _I]
                     + [_P] * 18 + _KNOBS + [_P],
    "mpc_pcg_plan": [_I] * 5 + [_P],
    "mpc_pcg_scratch_floats": [_I] * 5,
    "mpc_pcg": [_I, _I] + [_P] * 14 + [_I, _F] + [_P] * 6 + [_I] * 4
               + [_P],
    "mpc_bcr_pcg_dz": [_I] + [_P] * 11 + [_I, _F] + [_P] * 6 + [_I, _P],
    "mpc_bcr_cluster": [_I, _I],
    "mpc_bcr_max_knots": [],
    "mpc_bcr_cluster_factor_host": [_I, _I] + [_P] * 4,
    "mpc_bcr_cluster_apply_host": [_I, _I] + [_P] * 3,
    "mpc_cluster_dot_host": [_I, _I] + [_P] * 3,
    "mpc_bcr_scratch_floats": [_I],
    "mpc_bcr_dz": [_I] + [_P] * 15 + [_I, _P],
    "mpc_bcr_dz_cluster": [_I, _I],
    "mpc_bcr_dz_max_knots": [],
    "mpc_bcr_solve": [_I] + [_P] * 7 + [_I, _P],
    "mpc_bcr_solve_cluster": [_I, _I],
    "mpc_bcr_solve_max_knots": [],
    "mpc_bcr_one_block_solve_host": [_I] + [_P] * 6,
    "mpc_bcr_dz_one_block_host": [_I] + [_P] * 14,
    "mpc_bcr_cluster_dz_host": [_I, _I] + [_P] * 14,
    "mpc_sqp_mega": [_P, _I, _P, _P, _P, _I] + [_P] * 4
                    + [_F, _I, _F, _I] + [_F] * 5 + [_I] + [_F] * 4
                    + [_P] * 8 + [_I] * 4 + _KNOBS + [_P],
    "mpc_sqp_iter_mega_pcg": [_P, _I, _P, _P, _P, _I] + [_P] * 5
                             + [_I] + [_F] * 6 + [_I] + [_F] * 4
                             + [_P] * 8 + [_I] * 4 + _KNOBS + [_P],
    "mpc_sqp_iter_mega": [_P, _I, _P, _P, _P, _I] + [_P] * 4 + [_F] * 5
                         + [_I] + [_F] * 4 + [_P] * 8 + [_I, _I] + _KNOBS
                         + [_P],
    "mpc_mega_max_knots": [_I],
    "mpc_mega_grid": [_I, _I],
    "mpc_mega_cluster_plan": [_I] * 4 + [_P],
    "mpc_mega_grid_plan": [_I] * 3 + [_P],
    "mpc_sqp_mega_scratch_floats": [_I, _I, _I],
    "mpc_sqp_mega_packed": [_P, _I, _I, _P, _P, _P, _I, _I, _P, _P, _P, _P,
                            _I, _F, _I] + [_F] * 5 + [_I] + [_F] * 4
                           + [_P] * 7 + [_I, _I, _I] + _KNOBS + [_P],
    "mpc_mega_packed_plan": [_I] * 5 + [_P],
    "mpc_mega_packed_max_knots": [_I, _I],
    "mpc_sqp_mega_packed_scratch_floats": [_I, _I, _I],
    "mpc_spmv_halo": [_I, _I] + [_P] * 8,
    "mpc_spmv_halo_max_shards": [],
    "mpc_emu_threads_host": [_I],
    "mpc_joined_cg_host": [_I] * 5 + [_P] * 8 + [_I, _F, _P, _P],
    "mpc_stage4_host": [_I] * 6 + [_P] * 14 + [_I, _F] + [_P] * 4,
    "mpc_ld_aba_host": [_P, _P, _P, _P, _F, _P],
    "mpc_ld_crba_host": [_P, _P, _P],
    "mpc_ld_rnea_host": [_P, _P, _P, _P, _F, _P, _P],
    "mpc_ld_fk_host": [_P, _P, _P, _P],
    "mpc_ld_dtau_host": [_P, _P, _P, _P, _F, _P],
    "mpc_ld_spd_inverse_host": [_I, _I, _P],
    "mpc_k2_contrib_host": [_P] * 6 + [_I, _P, _I, _I] + [_F] * 6
                           + [_I, _P] + _KNOBS,
}
_RESTYPES = {"mpc_bcr_scratch_floats": ctypes.c_longlong,
             "mpc_pcg_scratch_floats": ctypes.c_longlong,
             "mpc_sqp_mega_scratch_floats": ctypes.c_longlong,
             "mpc_sqp_mega_packed_scratch_floats": ctypes.c_longlong}

# entries of the host build alone (test hooks that run no device code)
_HOST_ONLY = {"mpc_bcr_cluster_factor_host", "mpc_bcr_cluster_apply_host",
              "mpc_bcr_one_block_solve_host", "mpc_bcr_dz_one_block_host",
              "mpc_bcr_cluster_dz_host",
              "mpc_cluster_dot_host", "mpc_emu_threads_host",
              "mpc_joined_cg_host", "mpc_stage4_host",
              "mpc_ld_aba_host", "mpc_ld_crba_host", "mpc_ld_rnea_host",
              "mpc_ld_fk_host", "mpc_ld_dtau_host", "mpc_ld_spd_inverse_host",
              "mpc_k2_contrib_host"}

_libs: dict = {}


def _stale(lib: Path) -> bool:
    if not lib.exists():
        return True
    newest = max((CSRC / f).stat().st_mtime for f in SOURCES + HEADERS)
    return lib.stat().st_mtime < newest


def _run(cmds, outs) -> list:
    """Run the commands at once, each writing its output file (atomically:
    to a temporary name, renamed on success); return their logs."""
    BUILD.mkdir(parents=True, exist_ok=True)
    tmps = [out.with_name(f"{out.name}.{os.getpid()}.tmp") for out in outs]
    procs = [subprocess.Popen([*cmd, "-o", str(tmp)], cwd=CSRC,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for cmd, tmp in zip(cmds, tmps)]
    logs, failed = [], []
    for cmd, proc, tmp, out in zip(cmds, procs, tmps, outs):
        log = proc.communicate()[0]
        logs.append(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{' '.join(cmd[:1])} -> {out.name}, rc "
                          f"{proc.returncode}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def _compile(cmd, out: Path) -> str:
    log = _run([cmd], [out])[0]
    out.with_suffix(".log").write_text(log)
    return log


def _bind(path: Path, nj: int) -> ctypes.CDLL:
    """Bind the library's entries; a build of NJ_SOURCES (nj != 7) leaves
    out the others' entries, as every build but the host's leaves out the
    host-only ones."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        if ((name in _HOST_ONLY or nj != IIWA_NJ)
                and not hasattr(lib, name)):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    lib.joints = nj
    return lib


def nvcc_path() -> str:
    found = os.environ.get("NVCC") or shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set NVCC or put the CUDA toolkit on PATH)")


def check_nj(nj: int) -> int:
    if not MIN_NJ <= nj <= MAX_NJ:
        raise ValueError(f"the CUDA kernels serve robots of {MIN_NJ}-{MAX_NJ} "
                         f"joints, got {nj}")
    return nj


def _suffix(nj: int) -> str:
    return "" if nj == IIWA_NJ else f"_nj{nj}"


def _sources(nj: int) -> tuple:
    return SOURCES if nj == IIWA_NJ else NJ_SOURCES


def _library_path(nj: int) -> Path:
    return BUILD / f"libmpcgpu_kernels{_suffix(check_nj(nj))}.so"


def _build_commands(nj: int):
    """(compile commands, their objects): one ``nvcc -c`` per source of
    the nj-joint build."""
    nvcc = nvcc_path()
    srcs = _sources(check_nj(nj))
    objs = [BUILD / f"{Path(src).stem}{_suffix(nj)}.o" for src in srcs]
    return ([[nvcc, *NVCC_FLAGS, f"-DMPC_NJ={nj}", "-c", src]
             for src in srcs], objs)


def build(force: bool = False, nj: int = IIWA_NJ) -> Path:
    """Compile the CUDA library of nj joints if it is missing or stale;
    return its path.  The build log (ptxas' registers and spills per
    kernel) is written beside it with the suffix .log."""
    return build_all(force, (nj,))[0]


def build_all(force: bool = False, counts=(IIWA_NJ,)) -> list:
    """build() for each joint count, the sources of every count compiled
    at once, then one link each; returns the libraries' paths."""
    outs = [_library_path(nj) for nj in counts]
    todo = [(nj, out) for nj, out in zip(counts, outs)
            if force or _stale(out)]
    if todo:
        cmds, objs, spans = [], [], []
        for nj, _ in todo:
            c, o = _build_commands(nj)
            spans.append((len(objs), len(objs) + len(o)))
            cmds += c
            objs += o
        logs = _run(cmds, objs)
        links = _run([[nvcc_path(), *ARCH, "-shared",
                       *map(str, objs[a:b])] for a, b in spans],
                     [out for _, out in todo])
        for (_, out), (a, b), link in zip(todo, spans, links):
            out.with_suffix(".log").write_text("".join(logs[a:b]) + link)
    return outs


def ptxas_resources(log: str, fragments) -> dict:
    """{fragment: (registers line, stack and spill line)} from a build log
    (ptxas -v), for the first kernel whose mangled name holds each
    fragment; raises if a fragment names no kernel of the log."""
    lines = log.splitlines()
    found = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" not in line:
            continue
        for frag in fragments:
            if frag in line and frag not in found:
                follow = lines[i + 1:i + 4]
                regs = next((x.split(":", 1)[1].strip() for x in follow
                             if "registers" in x), None)
                stack = next((x.strip() for x in follow
                              if "stack frame" in x), None)
                if regs is None or stack is None:
                    raise RuntimeError(f"ptxas log: no resource lines for "
                                       f"{line.strip()}")
                found[frag] = (regs, stack)
    missing = [f for f in fragments if f not in found]
    if missing:
        raise RuntimeError(f"ptxas log: no kernel matching {missing}")
    return found


def library(nj: int = IIWA_NJ) -> ctypes.CDLL:
    """The bound CUDA library of nj joints (built at first use)."""
    if ("cuda", nj) not in _libs:
        _libs["cuda", nj] = _bind(build(nj=nj), nj)
    return _libs["cuda", nj]


def host_library(nj: int = IIWA_NJ) -> ctypes.CDLL:
    """The same sources built by the host C++ compiler (see module doc)."""
    if ("host", nj) not in _libs:
        cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
        if not cxx:
            raise RuntimeError("no host C++ compiler found")
        out = BUILD / f"libmpcgpu_kernels_host{_suffix(check_nj(nj))}.so"
        if _stale(out):
            _compile([cxx, "-x", "c++", "-std=c++17", "-O2", "-shared",
                      "-fPIC", "-pthread", "-Wno-unknown-pragmas",
                      f"-DMPC_NJ={nj}", *_sources(nj)], out)
        _libs["host", nj] = _bind(out, nj)
    return _libs["host", nj]


class Knobs(NamedTuple):
    """The solver's knobs that the stage kernels (K2, K3, K5, K5g, K9p,
    K9pg, K9b, K10) take, under SolverConfig's names: the tracking cost
    ("eepos" or "joint", with the position weight q_cost), the eepos
    Hessian ("reference" or "gauss_newton"), the integrator (0 explicit, 1
    semi-implicit Euler) and the angle wrap.  The defaults are the
    configuration's."""

    tracking: str = "eepos"
    hessian: str = "reference"
    integrator_type: int = 0
    angle_wrap: bool = False
    q_cost: float = 1.0

    def kkt_kw(self) -> dict:
        """The keywords of the plain ops.kkt.form_kkt."""
        return dict(integrator_type=self.integrator_type,
                    hessian=self.hessian, angle_wrap=self.angle_wrap,
                    tracking=self.tracking, q_cost=self.q_cost)

    def merit_kw(self) -> dict:
        """The keywords of the plain ops.merit functions (no Hessian)."""
        kw = self.kkt_kw()
        del kw["hessian"]
        return kw


DEFAULT_KNOBS = Knobs()


def knobs_of(cfg) -> Knobs:
    """A SolverConfig's knobs."""
    cc = cfg.cost
    return Knobs(cc.tracking, cc.hessian, cfg.integrator_type,
                 bool(cfg.angle_wrap), cc.q_cost)


def knob_args(knobs: Knobs) -> tuple:
    """The knobs as the C entries take them (ld::Knobs, lanedyn.cuh):
    tracking, hessian, integrator, wrap, q_cost; raise on a value the
    kernels do not serve."""
    codes = dict(tracking={"eepos": 0, "joint": 1},
                 hessian={"reference": 0, "gauss_newton": 1},
                 integrator_type={0: 0, 1: 1})
    out = []
    for name, table in codes.items():
        v = getattr(knobs, name)
        if v not in table:
            raise ValueError(f"{name}={v!r} (the kernels serve "
                             f"{list(table)})")
        out.append(table[v])
    return (*out, int(bool(knobs.angle_wrap)), float(knobs.q_cost))


def expect_goals(goals: torch.Tensor, n: int, nx: int, knobs: Knobs,
                 lead: tuple = ()) -> None:
    """Raise unless goals are lead + (n, width) rows of the width the
    tracking cost reads: at least 3 (the end-effector position first) for
    "eepos", nx (the joint states) for "joint"."""
    shape = tuple(goals.shape)
    k = len(lead)
    ok = goals.dim() == k + 2 and shape[:k + 1] == (*lead, n)
    if knobs.tracking == "joint":
        ok, want = ok and shape[-1] == nx, f"{nx}"
    else:
        ok, want = ok and shape[-1] >= 3, ">=3"
    if not ok:
        dims = ", ".join(map(str, (*lead, n, want)))
        raise ValueError(f"goals must be ({dims}) under tracking="
                         f"{knobs.tracking!r}, got {shape}")


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def stream_of(t: torch.Tensor):
    """The current CUDA stream handle for t's device (None on the host)."""
    if t.device.type == "cuda":
        return torch.cuda.current_stream(t.device).cuda_stream
    return None


def expect(t: torch.Tensor, name: str, shape, device) -> None:
    """Raise unless t is a contiguous float32 tensor of this shape on device."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# Model tables packed in the csrc layout (lanedyn.cuh TAB_*), cached per
# model: keyed by the identity of the model's Xc tensor and checked through
# a weak reference, so a cached table never outlives or mismatches it.
_TABLE_FIELDS = ("Xc", "Xs", "Xk", "I", "Hc", "Hs", "Hk", "dHc", "dHs", "dHk")
_tables: dict = {}
TAB_PER_JOINT = 240   # floats of a joint's tables (TAB_SIZE / NJ)


def model_tables(model) -> torch.Tensor:
    """(240 nj,) float32 tables of an nj-joint model (2 <= nj <= 7), on
    the model's device."""
    nj = check_nj(model.num_joints)
    entry = _tables.get(id(model.Xc))
    if entry is not None and entry[0]() is model.Xc:
        return entry[1]
    tab = torch.cat([getattr(model, f).to(torch.float32).reshape(-1)
                     for f in _TABLE_FIELDS]).contiguous()
    if tab.numel() != TAB_PER_JOINT * nj:
        raise ValueError(f"model tables hold {tab.numel()} floats, the "
                         f"kernels expect {TAB_PER_JOINT * nj}")
    _tables[id(model.Xc)] = (weakref.ref(model.Xc), tab)
    return tab


def expect_joints(lib, nj: int) -> None:
    """Raise unless lib is the build of nj joints."""
    if lib.joints != nj:
        raise ValueError(f"the kernel library of {lib.joints} joints got a "
                         f"{nj}-joint problem")


def sizes(tab: torch.Tensor, lib=None):
    """(nj, nx, nu) of the robot whose packed tables (model_tables) tab
    are; raise unless lib (where given) is the build of that joint
    count."""
    if tab.numel() % TAB_PER_JOINT:
        raise ValueError(f"tables of {tab.numel()} floats are not "
                         f"{TAB_PER_JOINT} a joint")
    nj = check_nj(tab.numel() // TAB_PER_JOINT)
    if lib is not None:
        expect_joints(lib, nj)
    return nj, 2 * nj, nj


def width_joints(nx: int, lib=None) -> int:
    """The joint count of a state width nx (2 nj); raise unless lib (where
    given) is the build of that joint count."""
    if nx % 2:
        raise ValueError(f"state width {nx} is not 2 nj")
    nj = check_nj(nx // 2)
    if lib is not None:
        expect_joints(lib, nj)
    return nj


def require_iiwa(nj: int, kernel: str) -> None:
    """Raise unless nj is the IIWA's 7: kernel (a name) serves only it."""
    if nj != IIWA_NJ:
        raise ValueError(f"{kernel} serves {IIWA_NJ}-joint robots only, got "
                         f"{nj} joints (the kernels of other joint counts: "
                         f"K1-K5)")
