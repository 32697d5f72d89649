"""GCRA (generic cell rate algorithm) transition (Algorithm.GCRA).

Virtual scheduling on one ``tat`` (theoretical arrival time) column: with
emission interval ``T = duration // limit`` and tolerance
``tau = (burst_eff - 1) * T`` (``burst_eff = burst`` when positive, else
``limit``), ``hits`` conform iff the last cell's arrival
``tat + (hits - 1) * T`` is within ``tau`` of now.  Conforming hits
advance ``tat`` by ``hits * T`` after a stale ``tat`` catches up to now.

``hits > 0`` is all-or-nothing (DRAIN_OVER_LIMIT is a no-op);
``hits < 0`` returns credit, ``tat' = max(tat + hits * T, t)``;
``hits == 0`` is a status query that does not bump expiry.  ``remaining``
is the number of cells that would still conform, ``reset_time`` the
instant the next cell conforms, and expiry ``max(t + duration, tat)``.
"""

from __future__ import annotations

from gubernator_tpu_torch.algos.table import ZooResp, ZooState, status_of
from gubernator_tpu_torch.types import Algorithm


def transition(o, s, r, exists, reset_b, drain_b
               ) -> tuple[ZooState, ZooResp]:
    """Elementwise GCRA step over backend ``o`` (see table.py)."""
    zero = o.const(0, r["algorithm"])
    one = o.const(1, r["algorithm"])

    ex = exists & ~reset_b & (s["algorithm"] == int(Algorithm.GCRA))
    t = r["created_at"]
    limit = r["limit"]
    # Emission interval on the floor_div domain (duration >= 0, limit > 0).
    safe_limit = o.select(o.le(limit, zero), one, limit)
    T = o.floor_div(o.max_(r["duration"], zero), safe_limit)
    burst_eff = o.select(o.gt(r["burst"], zero), r["burst"], limit)
    tau = o.mul(o.sub(burst_eff, one), T)

    tat0 = o.select(ex, s["tat"], t)
    tat1 = o.max_(tat0, t)  # stale tat catches up to now

    h = r["hits"]
    h_pos = o.gt(h, zero)
    h_neg = o.lt(h, zero)
    h_query = o.is_zero(h)
    need = o.add(tat1, o.mul(o.sub(h, one), T))
    horizon = o.add(t, tau)
    conform = o.le(need, horizon)
    admit = h_pos & conform
    over = h_pos & ~conform

    stepped = o.add(tat1, o.mul(h, T))
    tat2 = o.select(
        admit, stepped,
        o.select(h_neg, o.max_(stepped, t), tat1),
    )

    slack = o.sub(horizon, tat2)
    t_zero = o.is_zero(T)
    rem_div = o.add(o.floor_div(o.max_(slack, zero), o.max_(T, one)), one)
    rem = o.select(
        o.lt(slack, zero), zero,
        o.select(t_zero, burst_eff, o.min_(rem_div, burst_eff)),
    )
    rem = o.max_(rem, zero)  # burst_eff <= 0 (limit <= 0) floors at 0

    status = status_of(over | (h_query & o.is_zero(rem)))
    reset = o.max_(o.sub(tat2, tau), t)
    touch = ~h_query | ~ex
    expire = o.select(
        touch, o.max_(o.add(t, r["duration"]), tat2), s["expire_at"])

    st = ZooState(remaining=rem, created_at=o.select(ex, s["created_at"], t),
                  status=status, expire_at=expire, tat=tat2, prev_count=zero)
    resp = ZooResp(status=status, remaining=rem, reset_time=reset,
                   over_limit=over)
    return st, resp
