"""PyTorch/CUDA port of the gubernator-tpu tick engine.

The package runs on an NVIDIA GPU: its kernels are CUDA C++ for Hopper
(``csrc/``), built with ``nvcc`` at first use (:mod:`._build`) and bound
with ctypes.  Every kernel has a plain PyTorch version beside it, which
runs only for tensors that live on the CPU.  Entry points pick the CUDA
device unless the caller passes ``device="cpu"``; with no card present
and no explicit device they raise instead of quietly running on the CPU.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """The CUDA device, or a clear error when no card is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "gubernator_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return torch.device("cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a torch.device; ``None`` means :func:`default_device`."""
    return default_device() if device is None else torch.device(device)


def kernel_launches() -> dict:
    """Launch count of every CUDA kernel wrapper, by kernel name."""
    from gubernator_tpu_torch.ops import fusedtick, raggedtick, rowtable

    return {
        "fused_tick": fusedtick.fused_tick.launches,
        "fused_merged_tick": fusedtick.fused_merged_tick.launches,
        "fused_ragged_tick": raggedtick.fused_ragged_tick.launches,
        "gather_rows": rowtable.gather_rows.launches,
        "scatter_rows": rowtable.scatter_rows.launches,
    }


def reset_kernel_launches() -> None:
    from gubernator_tpu_torch.ops import fusedtick, raggedtick, rowtable

    fusedtick.fused_tick.launches = 0
    fusedtick.fused_merged_tick.launches = 0
    raggedtick.fused_ragged_tick.launches = 0
    rowtable.gather_rows.launches = 0
    rowtable.scatter_rows.launches = 0


__all__ = [
    "default_device", "resolve_device", "kernel_launches",
    "reset_kernel_launches",
]
