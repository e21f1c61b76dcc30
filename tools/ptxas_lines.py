"""Build the CUDA library anew and print ptxas' registers, stack and spills
for the kernels K1, K3 and the megakernels that run K3's stage bodies.

    python3 tools/ptxas_lines.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mpcgpu_tpu_torch.ops.cuda import _lib  # noqa: E402

KERNELS = ("rollout_kernel", "k3_perknot", "k3_theta", "k3_stair",
           "15sqp_mega_kernelE", "sqp_mega_grid_kernel",
           "sqp_iter_mega_pcg_kernel", "sqp_mega_packed_kernel")


def main() -> int:
    path = _lib.build(force=True)
    found = _lib.ptxas_resources(path.with_suffix(".log").read_text(),
                                 KERNELS)
    for frag, (regs, stack) in found.items():
        print(f"{frag}: {regs} | {stack}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
