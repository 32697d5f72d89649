"""The N-way branchless policy table and its int64 torch backend.

Every zoo algorithm (:mod:`.sliding_window`, :mod:`.gcra`,
:mod:`.concurrency`) is written once against the ops protocol below:
elementwise 64-bit add/sub/mul/compare/select plus floor division and
modulo on the ``a >= 0, b > 0`` domain (callers clamp the operands into
it).  :class:`TorchOps` is the int64 tensor backend, the counterpart of
the TPU package's ``X64Ops``: products wrap two's-complement, and ``//``
and ``%`` are floor operations, as ``jnp`` defines them.  Boolean masks
are plain bool tensors; status values are int64 0/1.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from gubernator_tpu_torch.types import Algorithm


class TorchOps:
    """int64 tensor backend."""

    @staticmethod
    def const(v, like):
        return torch.full_like(like, v, dtype=torch.int64)

    @staticmethod
    def add(a, b):
        return a + b

    @staticmethod
    def sub(a, b):
        return a - b

    @staticmethod
    def mul(a, b):
        return a * b  # wraps two's-complement

    @staticmethod
    def eq(a, b):
        return a == b

    @staticmethod
    def lt(a, b):
        return a < b

    @staticmethod
    def le(a, b):
        return a <= b

    @staticmethod
    def gt(a, b):
        return a > b

    @staticmethod
    def is_zero(a):
        return a == 0

    @staticmethod
    def select(c, a, b):
        return torch.where(c, a, b)

    @staticmethod
    def max_(a, b):
        return torch.maximum(a, b)

    @staticmethod
    def min_(a, b):
        return torch.minimum(a, b)

    @staticmethod
    def floor_div(a, b):
        # Domain a >= 0, b > 0 (callers clamp); floor like jnp's `//`.
        return torch.div(a, b, rounding_mode="floor")

    @staticmethod
    def mod(a, b):
        return torch.remainder(a, b)  # same domain; sign of the divisor


def status_of(over_limit: torch.Tensor) -> torch.Tensor:
    """OVER_LIMIT where the mask holds, else UNDER_LIMIT (int64 lanes)."""
    return over_limit.to(torch.int64)


class ZooState(NamedTuple):
    """The state fields a zoo transition decides per lane; the rest of the
    row is uniform across zoo algorithms and filled by the caller."""

    remaining: Any
    created_at: Any
    status: Any
    expire_at: Any
    tat: Any
    prev_count: Any


class ZooResp(NamedTuple):
    status: Any
    remaining: Any
    reset_time: Any
    over_limit: Any   # bool lanes


def _pick(alg, sw, gc, cc):
    """3-way zoo select keyed on the request algorithm; values other than
    GCRA and CONCURRENCY resolve to sliding-window."""
    is_gc = alg == int(Algorithm.GCRA)
    is_cc = alg == int(Algorithm.CONCURRENCY)
    return torch.where(is_gc, gc, torch.where(is_cc, cc, sw))


def zoo_transitions(o, s, r, exists, reset_b, drain_b
                    ) -> tuple[ZooState, ZooResp]:
    """Run all three zoo transitions branchlessly and fold them into one
    per-lane result keyed on ``r["algorithm"]``.  ``s`` and ``r`` are dicts
    of logical state and request columns; ``exists``/``reset_b``/``drain_b``
    are the caller's shared masks."""
    from gubernator_tpu_torch.algos import concurrency, gcra, sliding_window

    sw_s, sw_r = sliding_window.transition(o, s, r, exists, reset_b, drain_b)
    gc_s, gc_r = gcra.transition(o, s, r, exists, reset_b, drain_b)
    cc_s, cc_r = concurrency.transition(o, s, r, exists, reset_b, drain_b)
    alg = r["algorithm"]
    st = ZooState(*(_pick(alg, a, b, c) for a, b, c in zip(sw_s, gc_s, cc_s)))
    resp = ZooResp(*(_pick(alg, a, b, c) for a, b, c in zip(sw_r, gc_r, cc_r)))
    return st, resp
