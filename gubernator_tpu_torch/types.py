"""Wire-level types: algorithms, behaviors, status, request/response.

The port's own copy of the reference contract (``gubernator.proto:56-203``):
``Algorithm`` (token and leaky bucket plus the sliding-window, GCRA and
concurrency extensions), ``Behavior`` bitflags, ``Status``, and the
``RateLimitRequest`` / ``RateLimitResponse`` dataclasses, the
owner-pushed ``GlobalUpdate``, and the service layer's ``PeerInfo`` and
``HealthCheckResponse``.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Optional


class Algorithm(enum.IntEnum):
    TOKEN_BUCKET = 0
    LEAKY_BUCKET = 1
    # Algorithm-zoo extensions (algos/): same table row, same dispatch,
    # selected per lane by this column.
    SLIDING_WINDOW = 2
    GCRA = 3
    CONCURRENCY = 4


# Highest wire-valid Algorithm value; anything outside [0, ALGORITHM_MAX]
# is rejected at the edge with INVALID_ARGUMENT.
ALGORITHM_MAX = max(Algorithm)


class Behavior(enum.IntFlag):
    """Bitflags controlling per-request behavior (gubernator.proto:63-135).

    BATCHING is the zero value (default); flags combine with ``|``.
    """

    BATCHING = 0
    NO_BATCHING = 1
    GLOBAL = 2
    DURATION_IS_GREGORIAN = 4
    RESET_REMAINING = 8
    MULTI_REGION = 16
    DRAIN_OVER_LIMIT = 32


class Status(enum.IntEnum):
    UNDER_LIMIT = 0
    OVER_LIMIT = 1


# Gregorian interval selectors carried in `duration` when
# DURATION_IS_GREGORIAN is set (reference interval.go:74-81).
GREGORIAN_MINUTES = 0
GREGORIAN_HOURS = 1
GREGORIAN_DAYS = 2
GREGORIAN_WEEKS = 3
GREGORIAN_MONTHS = 4
GREGORIAN_YEARS = 5


# Hard cap on items per GetRateLimits call (reference gubernator.go:39-40).
MAX_BATCH_SIZE = 1000


@dataclass
class RateLimitRequest:
    """One rate-limit check (reference RateLimitReq, gubernator.proto:137-183)."""

    name: str = ""
    unique_key: str = ""
    hits: int = 0
    limit: int = 0
    duration: int = 0  # milliseconds (or Gregorian selector)
    algorithm: int = Algorithm.TOKEN_BUCKET
    behavior: int = Behavior.BATCHING
    burst: int = 0
    metadata: Dict[str, str] = field(default_factory=dict)
    created_at: Optional[int] = None  # epoch ms; stamped by server when None
    # Absolute local-monotonic admission deadline (seconds), stamped at
    # the serving edge.  Never serialized: the wire carries the relative
    # budget in the ``guber-deadline-ms`` metadata key.
    deadline: Optional[float] = None

    def hash_key(self) -> str:
        """The cluster-sharding key: ``name_uniquekey`` (reference client.go:39-41)."""
        return self.name + "_" + self.unique_key


@dataclass
class RateLimitResponse:
    """Result of one rate-limit check (reference RateLimitResp)."""

    status: int = Status.UNDER_LIMIT
    limit: int = 0
    remaining: int = 0
    reset_time: int = 0
    error: str = ""
    metadata: Dict[str, str] = field(default_factory=dict)


@dataclass
class GlobalUpdate:
    """Owner-pushed authoritative GLOBAL bucket state
    (reference UpdatePeerGlobal, peers.proto:52-72)."""

    key: str
    status: "RateLimitResponse"
    algorithm: int = Algorithm.TOKEN_BUCKET
    duration: int = 0
    created_at: int = 0


@dataclass(frozen=True)
class PeerInfo:
    """One cluster member (reference config.go:161-175)."""

    grpc_address: str = ""
    http_address: str = ""
    datacenter: str = ""
    is_owner: bool = False  # set only on the local instance's own entry

    def hash_key(self) -> str:
        """Ring identity of the peer (reference HashKey() = GRPCAddress)."""
        return self.grpc_address


@dataclass
class HealthCheckResponse:
    status: str = "healthy"
    message: str = ""
    peer_count: int = 0


def has_behavior(behavior: int, flag: int) -> bool:
    """Bitflag test (reference gubernator.go:776-781): always False for
    the zero-valued BATCHING flag."""
    return bool(behavior & flag)


def set_behavior(behavior: int, flag: int, on: bool) -> int:
    """Bitflag set/clear (reference gubernator.go:783-788)."""
    return (behavior | flag) if on else (behavior & ~flag)
