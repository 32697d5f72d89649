"""The algorithm zoo: sliding-window, GCRA and concurrency limits.

Each algorithm is one elementwise state transition written against the
small ops protocol of :mod:`.table` and folded per lane on the
``algorithm`` column, so a window that mixes all five algorithms still
runs as one pass.  :class:`.table.TorchOps` evaluates the formulas on
int64 tensors; the CUDA tick kernel carries a scalar C++ copy of the same
formulas (``csrc/transition.cuh``).
"""

from __future__ import annotations

from gubernator_tpu_torch.types import Algorithm

# Zoo members are selected when ``algorithm >= ZOO_MIN``; token and leaky
# bucket stay on the two-way select of ops/transition.py.
ZOO_MIN = int(Algorithm.SLIDING_WINDOW)
