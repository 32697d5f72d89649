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
    from gubernator_tpu_torch.ops import rowtable

    return {
        **{name: w.launches for name, w in _lane_wrappers().items()},
        "gather_rows": rowtable.gather_rows.launches,
        "scatter_rows": rowtable.scatter_rows.launches,
    }


def _lane_wrappers() -> dict:
    """The wrappers that also count their launches by lane width: the
    ticks, the lease-column window and the GLOBAL mesh's kernels (a
    reconcile's width is the capacity, a sparse apply's its union)."""
    from gubernator_tpu_torch.ops import (
        fusedtick, globalmesh, leasecols, raggedtick, sortedtick, tiletick)

    return {
        "fused_tick": fusedtick.fused_tick,
        "fused_merged_tick": fusedtick.fused_merged_tick,
        "fused_ragged_tick": raggedtick.fused_ragged_tick,
        "fused_sorted_tick": sortedtick.fused_sorted_tick,
        "mesh_tile_tick": tiletick.mesh_tile_tick,
        "lease_apply": leasecols.lease_apply,
        **globalmesh.WRAPPERS,
    }


def kernel_launches_by_width() -> dict:
    """Launch counts of each tick kernel, of the lease-column window and
    of the GLOBAL mesh's kernels by lane width: ``{kernel: {bucket: count}}``, a bucket being the least
    power of two at or above a launch's width."""
    return {name: dict(sorted(w.launches_by_width.items()))
            for name, w in _lane_wrappers().items()}


def reset_kernel_launches() -> None:
    """Every kernel's launch count, and the counts by width, to 0."""
    from gubernator_tpu_torch.ops import rowtable

    for w in _lane_wrappers().values():
        w.launches = 0
        w.launches_by_width = {}
    rowtable.gather_rows.launches = 0
    rowtable.scatter_rows.launches = 0


__all__ = [
    "default_device", "resolve_device", "kernel_launches",
    "kernel_launches_by_width", "reset_kernel_launches",
]
