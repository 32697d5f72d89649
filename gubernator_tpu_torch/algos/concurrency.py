"""Concurrency / in-flight limit transition (Algorithm.CONCURRENCY).

``remaining`` holds the free slot count.  Positive hits acquire slots
(all-or-nothing), negative hits release them (clamped into
``[0, limit]``), and a bucket whose TTL lapses is re-created full, which
reclaims slots leaked by holders that never released.  ``hits == 0`` is a
status query that does not refresh the TTL.  A limit change re-bases the
free count by the delta, clamped at 0.  ``reset_time`` is ``expire_at``.
"""

from __future__ import annotations

from gubernator_tpu_torch.algos.table import ZooResp, ZooState, status_of
from gubernator_tpu_torch.types import Algorithm


def transition(o, s, r, exists, reset_b, drain_b
               ) -> tuple[ZooState, ZooResp]:
    """Elementwise concurrency-limit step over backend ``o`` (table.py)."""
    zero = o.const(0, r["algorithm"])

    ex = exists & ~reset_b & (s["algorithm"] == int(Algorithm.CONCURRENCY))
    t = r["created_at"]
    limit = r["limit"]
    rebased = o.add(s["remaining"], o.sub(limit, s["limit"]))
    rem0 = o.max_(o.select(ex, rebased, limit), zero)

    h = r["hits"]
    h_pos = o.gt(h, zero)
    h_neg = o.lt(h, zero)
    h_query = o.is_zero(h)
    fits = o.le(h, rem0)
    admit = h_pos & fits
    over = h_pos & ~fits

    rem1 = o.select(
        admit,
        o.sub(rem0, h),
        o.select(h_neg, o.max_(o.min_(o.sub(rem0, h), limit), zero), rem0),
    )

    touch = ~h_query | ~ex
    expire = o.select(touch, o.add(t, r["duration"]), s["expire_at"])
    status = status_of(over | (h_query & o.is_zero(rem1)))

    st = ZooState(remaining=rem1, created_at=o.select(ex, s["created_at"], t),
                  status=status, expire_at=expire, tat=zero, prev_count=zero)
    resp = ZooResp(status=status, remaining=rem1, reset_time=expire,
                   over_limit=over)
    return st, resp
