#!/usr/bin/env python3
"""IIWA tracking with the host LDL' oracle backend on the PyTorch + CUDA
port: counterpart of examples/track_iiwa_qdldl.py (reference
examples/track_iiwa_qdldl.cu:14-156).

The driver of track_iiwa_pcg_torch.py with the exact LDL' factorization
in place of PCG (one tolerance slot, -1 as the reference's), the plain
stages on the card (or the CPU with --cpu) and the factorization on the
host.  A thin wrapper over that driver.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from track_iiwa_pcg_torch import main  # noqa: E402


def main_qdldl(argv=None):
    args = list(sys.argv[1:] if argv is None else argv)
    return main(args + ["--linsys", "qdldl", "--tols", "-1"])


if __name__ == "__main__":
    main_qdldl()
