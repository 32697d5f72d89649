"""Sliding-window counter transition (Algorithm.SLIDING_WINDOW).

Epoch-aligned windows of ``duration`` ms: the current window's count
lives in ``remaining`` (it counts up), the previous window's final count
in ``prev_count``, and the current window start in ``created_at``.  The
usage at time ``t`` weights the previous window by its remaining overlap:

    used = prev * (duration - (t - window_start)) // duration + cur

``hits > 0`` admits iff ``hits <= limit - used`` (DRAIN_OVER_LIMIT
consumes exactly the available budget on a reject); ``hits < 0``
un-counts, clamped at 0; ``hits == 0`` is a status query that does not
bump expiry.  RESET_REMAINING discards the stored window.  ``reset_time``
is the current window's end; expiry is ``t + 2 * duration``.
"""

from __future__ import annotations

from gubernator_tpu_torch.algos.table import ZooResp, ZooState, status_of
from gubernator_tpu_torch.types import Algorithm


def transition(o, s, r, exists, reset_b, drain_b
               ) -> tuple[ZooState, ZooResp]:
    """Elementwise sliding-window step over backend ``o`` (see table.py)."""
    zero = o.const(0, r["algorithm"])
    one = o.const(1, r["algorithm"])

    ex = exists & ~reset_b & (s["algorithm"] == int(Algorithm.SLIDING_WINDOW))
    # The window math needs t >= 0 and duration >= 1 (the floor_div
    # domain); the clamps keep the transition total for hostile values.
    t = o.max_(r["created_at"], zero)
    dur = o.max_(r["duration"], one)
    aligned = o.sub(t, o.mod(t, dur))

    ws0 = o.select(ex, s["created_at"], aligned)
    cur0 = o.select(ex, o.max_(s["remaining"], zero), zero)
    prev0 = o.select(ex, o.max_(s["prev_count"], zero), zero)

    # Rotation: k full windows elapsed since the stored window start.
    delta = o.max_(o.sub(t, ws0), zero)  # clock-regress clamp
    k = o.floor_div(delta, dur)
    k0 = o.is_zero(k)
    k1 = o.eq(k, one)
    prev1 = o.select(k0, prev0, o.select(k1, cur0, zero))
    cur1 = o.select(k0, cur0, zero)
    ws1 = o.select(k0, ws0, aligned)

    frac = o.min_(o.max_(o.sub(dur, o.sub(t, ws1)), zero), dur)
    wprev = o.floor_div(o.mul(prev1, frac), dur)
    used = o.add(wprev, cur1)
    avail = o.max_(o.sub(r["limit"], used), zero)

    h = r["hits"]
    h_pos = o.gt(h, zero)
    h_neg = o.lt(h, zero)
    h_query = o.is_zero(h)
    fits = o.le(h, avail)
    admit = h_pos & fits
    over = h_pos & ~fits

    cur2 = o.select(
        admit,
        o.add(cur1, h),
        o.select(
            over & drain_b,
            o.add(cur1, avail),
            o.select(h_neg, o.max_(o.add(cur1, h), zero), cur1),
        ),
    )
    resp_rem = o.max_(o.sub(r["limit"], o.add(wprev, cur2)), zero)
    status = status_of(over | (h_query & o.is_zero(avail)))
    reset = o.add(ws1, dur)
    touch = ~h_query | ~ex
    expire = o.select(touch, o.add(t, o.add(dur, dur)), s["expire_at"])

    st = ZooState(remaining=cur2, created_at=ws1, status=status,
                  expire_at=expire, tat=zero, prev_count=prev1)
    resp = ZooResp(status=status, remaining=resp_rem, reset_time=reset,
                   over_limit=over)
    return st, resp
