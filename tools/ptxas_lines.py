"""Build the CUDA library anew and print ptxas' registers, stack and spills
for the kernels K1, K2, K3, the megakernels that run K3's stage bodies
and K2's merit contributions (K10 in both its forms; K5g and K9pg beside
their grid-CG form's count, which held them to 3 blocks an SM; K9b, whose
refined BCR solve runs across the first cluster), the BCR kernels K6,
K7 and K7s (one cluster) and K4 and K4b in both forms (K4, K4b one
cluster; K4g, K4bg joined); then K5's and K9p's counts with their
__maxnreg__ cap lifted (sqp_mega.cu compiled alone, LD_MAXNREG empty).

    python3 tools/ptxas_lines.py
"""
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mpcgpu_tpu_torch.ops.cuda import _lib  # noqa: E402

KERNELS = ("rollout_kernel", "12merit_kernel", "k3_perknot", "k3_theta",
           "k3_stair", "15sqp_mega_kernelE", "24sqp_iter_mega_pcg_kernelE",
           "24sqp_iter_mega_bcr_kernel", "20sqp_mega_grid_kernel",
           "29sqp_iter_mega_pcg_grid_kernel", "22sqp_mega_packed_kernel",
           "30sqp_mega_packed_cluster_kernel", "17bcr_pcg_dz_kernel",
           "13bcr_dz_kernel", "16bcr_solve_kernel", "21pcg_dz_cluster_kernel",
           "24pcg_solve_cluster_kernel", "20pcg_dz_joined_kernel",
           "23pcg_solve_joined_kernel")
UNCAPPED = ("15sqp_mega_kernelE", "24sqp_iter_mega_pcg_kernelE")
# K5g's and K9pg's count with the grid-wide CG, before their CG was
# joined across clusters
GRID_CG_REGISTERS = {"20sqp_mega_grid_kernel": 168,
                     "29sqp_iter_mega_pcg_grid_kernel": 168}


def main() -> int:
    path = _lib.build(force=True)
    found = _lib.ptxas_resources(path.with_suffix(".log").read_text(),
                                 KERNELS)
    for frag, (regs, stack) in found.items():
        before = GRID_CG_REGISTERS.get(frag)
        print(f"{frag}: {regs} | {stack}"
              + (f" | with the grid-wide CG: {before} registers"
                 if before else ""))
    out = _lib.BUILD / "sqp_mega_uncapped.o"
    log = subprocess.run(
        [_lib.nvcc_path(), *_lib.NVCC_FLAGS, "-DLD_MAXNREG(n)=", "-c",
         str(_lib.CSRC / "sqp_mega.cu"), "-o", str(out)],
        capture_output=True, text=True, check=True)
    uncapped = _lib.ptxas_resources(log.stdout + log.stderr, UNCAPPED)
    for frag, (regs, stack) in uncapped.items():
        print(f"{frag} without its cap: {regs} | {stack}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
