"""The algorithm zoo: sliding-window, GCRA and concurrency limits.

Each algorithm is one elementwise state transition written against the
small ops protocol of :mod:`.table` and folded per lane on the
``algorithm`` column, so a window that mixes all five algorithms still
runs as one pass.  :class:`.table.TorchOps` evaluates the formulas on
int64 tensors; the CUDA tick kernel carries a scalar C++ copy of the same
formulas (``csrc/transition.cuh``).
"""

from __future__ import annotations

import numpy as np

from gubernator_tpu_torch.types import ALGORITHM_MAX, Algorithm

# Zoo members are selected when ``algorithm >= ZOO_MIN``; token and leaky
# bucket stay on the two-way select of ops/transition.py.
ZOO_MIN = int(Algorithm.SLIDING_WINDOW)


def invalid_algorithm_mask(algorithm) -> np.ndarray:
    """Boolean mask of wire ``algorithm`` values outside the enum range:
    the edges reject them with a per-item error instead of letting them
    run as token-bucket lanes."""
    a = np.asarray(algorithm)
    return (a < 0) | (a > int(ALGORITHM_MAX))


def algorithm_error(value: int) -> str:
    """The per-item error string for an out-of-range algorithm value."""
    return (
        f"invalid algorithm '{int(value)}': must be in "
        f"[0, {int(ALGORITHM_MAX)}]"
    )
