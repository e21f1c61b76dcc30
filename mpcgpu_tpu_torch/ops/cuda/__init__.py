"""Hand-written Hopper kernels (sources in ``mpcgpu_tpu_torch/csrc``).

Each kernel module holds the wrapper, its plain PyTorch version
(``*_reference``) and a launch counter (``wrapper.launches``).  Nothing
here builds or imports CUDA code at import time.
"""
from __future__ import annotations


def kernel_wrappers() -> dict:
    """{kernel id: wrapper} for K1-K6."""
    from mpcgpu_tpu_torch.ops.cuda.bcr_kernel import bcr_pcg_dz
    from mpcgpu_tpu_torch.ops.cuda.kkt_schur_kernel import form_kkt_schur
    from mpcgpu_tpu_torch.ops.cuda.merit_kernel import line_search_merits
    from mpcgpu_tpu_torch.ops.cuda.pcg_kernel import pcg_dz
    from mpcgpu_tpu_torch.ops.cuda.rollout_kernel import plant_rollout
    from mpcgpu_tpu_torch.ops.cuda.sqp_megakernel import sqp_solve_mega_pcg

    return {"K1": plant_rollout, "K2": line_search_merits,
            "K3": form_kkt_schur, "K4": pcg_dz, "K5": sqp_solve_mega_pcg,
            "K6": bcr_pcg_dz}


def reset_launch_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def launch_counts() -> dict:
    return {k: fn.launches for k, fn in kernel_wrappers().items()}
