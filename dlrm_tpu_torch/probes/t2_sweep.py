"""T2 t2_contract's design sweep on the card: the shipped kernel
(csrc/feasibility.cu) at every split of K over its cluster, then variants
of its CTA (thread tile, stage depth, the FFMA loop without loads, the
launch alone), at P6's shape and at chip_smoke.py's T2_SCALE, each with its
time on the card, its share of the operations bound and its error against
an fp64 product (probes/t2_sweep.cu, built by nvcc like the kernels).

    python -m dlrm_tpu_torch.probes.t2_sweep
"""

from __future__ import annotations

import ctypes
import sys

from dlrm_tpu_torch.buildlib import build_shared
from dlrm_tpu_torch.ops.stream_kernels import _NVCC_FLAGS, _nvcc
from dlrm_tpu_torch.probes.common import probe_device


def main(device: str = "cuda") -> int:
    """Build and run the sweep on the current card; it prints one line a
    configuration. Returns the CUDA error it ended with (0: none)."""
    if probe_device(device).type != "cuda":
        raise RuntimeError("the T2 sweep times the card: it needs CUDA")
    path = build_shared("t2_sweep", ["probes/t2_sweep.cu"],
                        [_nvcc(), *_NVCC_FLAGS],
                        deps=["csrc/feasibility.cu"])
    lib = ctypes.CDLL(path)
    lib.t2_sweep.restype = ctypes.c_int
    return lib.t2_sweep()


if __name__ == "__main__":
    sys.exit(main())
