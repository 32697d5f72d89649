"""Millisecond clocks and Gregorian calendar interval math.

Host-side equivalent of the reference's ``interval.go:74-148``
(``GregorianDuration`` / ``GregorianExpiration``).  Device kernels never
read clocks — time is always an input (see SURVEY.md §7 "Hard parts").

Like the reference, calendar math uses the process-local timezone and the
"end of interval" is the last representable millisecond of the interval
(interval start of the *next* interval minus 1 ms).

Deviation (conscious fix, documented per SURVEY.md §2.4 guidance): the
reference's month/year ``GregorianDuration`` mixes nanosecond and
millisecond units (``interval.go:99,105`` — ``end.UnixNano() -
begin.UnixNano()/1000000``). We return the intended value: the interval
length in milliseconds.
"""

from __future__ import annotations

import time
from datetime import datetime, timedelta

from gubernator_tpu_torch.types import (
    GREGORIAN_DAYS,
    GREGORIAN_HOURS,
    GREGORIAN_MINUTES,
    GREGORIAN_MONTHS,
    GREGORIAN_WEEKS,
    GREGORIAN_YEARS,
)


class GregorianError(ValueError):
    pass


def now_ms() -> int:
    """Wall clock in epoch milliseconds (reference lrucache.go:106-108)."""
    return time.time_ns() // 1_000_000


def _interval_bounds(now_ms_: int, d: int) -> tuple[int, int]:
    """(start_ms, next_start_ms) of the Gregorian interval containing now."""
    dt = datetime.fromtimestamp(now_ms_ / 1000.0)  # local time, like Go's now.Location()
    if d == GREGORIAN_MINUTES:
        start = dt.replace(second=0, microsecond=0)
        nxt = start + timedelta(minutes=1)
    elif d == GREGORIAN_HOURS:
        start = dt.replace(minute=0, second=0, microsecond=0)
        nxt = start + timedelta(hours=1)
    elif d == GREGORIAN_DAYS:
        start = dt.replace(hour=0, minute=0, second=0, microsecond=0)
        nxt = start + timedelta(days=1)
    elif d == GREGORIAN_WEEKS:
        # The reference left weeks as a TODO ("consider making a PR!",
        # interval.go:132); implemented here as ISO-8601 weeks — the
        # interval runs Monday 00:00:00.000 through Sunday 23:59:59.999.
        # DELIBERATE wire-visible divergence (documented in README
        # "Features"): the reference answers GregorianWeeks with a
        # calendar error, this implementation rate-limits.
        start = dt.replace(hour=0, minute=0, second=0, microsecond=0)
        start -= timedelta(days=dt.weekday())
        nxt = start + timedelta(days=7)
    elif d == GREGORIAN_MONTHS:
        start = dt.replace(day=1, hour=0, minute=0, second=0, microsecond=0)
        if start.month == 12:
            nxt = start.replace(year=start.year + 1, month=1)
        else:
            nxt = start.replace(month=start.month + 1)
    elif d == GREGORIAN_YEARS:
        start = dt.replace(month=1, day=1, hour=0, minute=0, second=0, microsecond=0)
        nxt = start.replace(year=start.year + 1)
    else:
        raise GregorianError(
            "behavior DURATION_IS_GREGORIAN is set; but `duration` is not a "
            "valid gregorian interval"
        )
    return int(start.timestamp() * 1000), int(nxt.timestamp() * 1000)


def gregorian_duration(now_ms_: int, d: int) -> int:
    """Entire duration of the Gregorian interval in ms (interval.go:84-109)."""
    if d == GREGORIAN_MINUTES:
        return 60_000
    if d == GREGORIAN_HOURS:
        return 3_600_000
    if d == GREGORIAN_DAYS:
        return 86_400_000
    start, nxt = _interval_bounds(now_ms_, d)  # raises for invalid d;
    # weeks/months/years computed from the interval bounds
    return nxt - start


def gregorian_expiration(now_ms_: int, d: int) -> int:
    """End of the current Gregorian interval in epoch ms (interval.go:117-148).

    E.g. for minutes at 11:20:10 → 11:20:59.999 as epoch ms.
    """
    _, nxt = _interval_bounds(now_ms_, d)
    return nxt - 1
