"""Hand-written Hopper kernels (sources in ``mpcgpu_tpu_torch/csrc``).

Each kernel module holds the wrapper, its plain PyTorch version
(``*_reference``) and a launch counter (``wrapper.launches``).  Nothing
here builds or imports CUDA code at import time.
"""
from __future__ import annotations


def kernel_wrappers() -> dict:
    """{kernel id: wrapper} for K1-K7, K7s, K9p, K9b, K10, the grid-CG
    forms K4g, K4bg, K5g and K9pg, and K6l (K6 with S in global memory).  K3 also serves the horizons of the
    TPU's tiled K8 (kkt_schur_kernel.py)."""
    from mpcgpu_tpu_torch.ops.cuda.bcr_kernel import (bcr_dz, bcr_pcg_dz,
                                                      bcr_pcg_dz_l2,
                                                      bcr_solve)
    from mpcgpu_tpu_torch.ops.cuda.kkt_schur_kernel import form_kkt_schur
    from mpcgpu_tpu_torch.ops.cuda.merit_kernel import line_search_merits
    from mpcgpu_tpu_torch.ops.cuda.pcg_kernel import (pcg_dz, pcg_dz_grid,
                                                      pcg_solve,
                                                      pcg_solve_grid)
    from mpcgpu_tpu_torch.ops.cuda.rollout_kernel import plant_rollout
    from mpcgpu_tpu_torch.ops.cuda.sqp_megakernel import (
        sqp_iter_mega, sqp_iter_mega_pcg, sqp_iter_mega_pcg_grid,
        sqp_solve_mega_pcg, sqp_solve_mega_pcg_grid,
        sqp_solve_mega_pcg_packed)

    return {"K1": plant_rollout, "K2": line_search_merits,
            "K3": form_kkt_schur, "K4": pcg_dz, "K4b": pcg_solve,
            "K5": sqp_solve_mega_pcg, "K6": bcr_pcg_dz, "K7": bcr_dz,
            "K7s": bcr_solve, "K9p": sqp_iter_mega_pcg, "K9b": sqp_iter_mega,
            "K10": sqp_solve_mega_pcg_packed, "K4g": pcg_dz_grid,
            "K4bg": pcg_solve_grid, "K5g": sqp_solve_mega_pcg_grid,
            "K9pg": sqp_iter_mega_pcg_grid, "K6l": bcr_pcg_dz_l2}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {k: fn.launches for k, fn in kernel_wrappers().items()}
