"""The whole per-lane bucket transition in plain int64/float64 torch ops.

Port of ``gubernator_tpu.ops.buckets.bucket_transition``: token and leaky
bucket as a branch-free ``torch.where`` chain with the reference's exact
precedence, folded with the algorithm zoo (:mod:`..algos`) on the
``algorithm`` column.  It keeps the reference's quirks:

* a duration-change renewal reports the pre-renewal ``remaining`` while
  the stored state is refilled;
* token-bucket ``OVER_LIMIT`` is persisted only on the already-at-zero
  branch;
* negative hits add tokens with no upper clamp (token bucket);
* a leaky Hits==0 query on an integer-zero remaining truncates away the
  fraction (exact-remainder precedes the query check);
* a new leaky item computes its rate from the raw duration even when
  DURATION_IS_GREGORIAN rewrites the stored duration.

This is the plain version of the CUDA tick kernel's transition
(``csrc/transition.cuh``), which computes the same values with scalar
C++ per lane.  Two closed-form duplicate folds follow it: ``merged_fold``
(the parts fold of the merged tick kernel, which the single-card plans
take) and ``merged_formulas`` with ``apply_merged_followers`` (the x64
fold of the mesh engine's duplicate windows, plain torch only).

float64 → int64 conversions go through :func:`trunc_i64` (round toward
zero, saturating, NaN → 0: what XLA gives the reference), and int64
products wrap two's-complement.
"""

from __future__ import annotations

from typing import Dict

import torch

from gubernator_tpu_torch.algos import ZOO_MIN
from gubernator_tpu_torch.algos import table as zoo_table
from gubernator_tpu_torch.types import Algorithm, Behavior, Status

I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)
_TWO63 = 9223372036854775808.0

UNDER = int(Status.UNDER_LIMIT)
OVER = int(Status.OVER_LIMIT)


def trunc_i64(x: torch.Tensor) -> torch.Tensor:
    """float64 → int64, truncating toward zero; out-of-range values
    saturate to the int64 bounds and NaN gives 0."""
    big = x >= _TWO63
    small = x < -_TWO63
    nan = torch.isnan(x)
    out = torch.where(big | small | nan, 0.0, x).to(torch.int64)
    out = torch.where(big, I64_MAX, out)
    return torch.where(small, I64_MIN, out)


def bucket_transition(now, s: Dict[str, torch.Tensor],
                      r: Dict[str, torch.Tensor]):
    """Apply one unique-slot batch of requests to their gathered states.

    ``s`` holds logical state columns (int64, ``remaining_f`` float64),
    ``r`` logical request columns (int64).  Returns ``(new_state, resp)``:
    the state columns to store, and ``status``/``remaining``/``reset_time``
    (int64) plus ``over_limit`` (bool)."""
    f64 = torch.float64
    behavior = r["behavior"]
    reset_b = (behavior & int(Behavior.RESET_REMAINING)) != 0
    drain_b = (behavior & int(Behavior.DRAIN_OVER_LIMIT)) != 0
    greg_b = (behavior & int(Behavior.DURATION_IS_GREGORIAN)) != 0

    # Cache-read existence: present and not expired (now > ExpireAt is a
    # miss, lrucache.go:111-128).
    exists = (r["known"] != 0) & (s["in_use"] != 0) & (now <= s["expire_at"])
    is_token = r["algorithm"] == int(Algorithm.TOKEN_BUCKET)
    algo_match = s["algorithm"] == r["algorithm"]

    h = r["hits"]
    limit = r["limit"]
    r_dur = r["duration"]
    r_created = r["created_at"]
    safe_limit_f = torch.where(limit == 0, 1, limit).to(f64)

    # -------- token bucket (algorithms.go:37-257) --------
    tok_reset = exists & reset_b
    tok_exist = exists & ~reset_b & algo_match

    t_rem0 = torch.where(
        s["limit"] != limit,
        torch.clamp_min(s["remaining"] + (limit - s["limit"]), 0),
        s["remaining"],
    )
    rl_status = s["status"]
    rl_rem_base = t_rem0
    dur_changed = s["duration"] != r_dur
    expire_cand = torch.where(greg_b, r["greg_exp"], s["created_at"] + r_dur)
    renew = expire_cand <= r_created
    expire_new = torch.where(renew, r_created + r_dur, expire_cand)
    t_created = torch.where(dur_changed & renew, r_created, s["created_at"])
    t_rem1 = torch.where(dur_changed & renew, limit, t_rem0)
    t_expire = torch.where(dur_changed, expire_new, s["expire_at"])
    rl_reset = t_expire

    t_query = h == 0
    t_at_zero = ~t_query & (rl_rem_base == 0) & (h > 0)
    t_exact = ~t_query & ~t_at_zero & (t_rem1 == h)
    t_over = ~t_query & ~t_at_zero & ~t_exact & (h > t_rem1)
    t_dec = ~t_query & ~t_at_zero & ~t_exact & ~t_over

    te_rem = torch.where(
        t_exact, 0,
        torch.where(t_over, torch.where(drain_b, 0, t_rem1),
                    torch.where(t_dec, t_rem1 - h, t_rem1)),
    )
    te_status = torch.where(t_at_zero, OVER, s["status"])
    te_resp_status = torch.where(t_at_zero | t_over, OVER, rl_status)
    te_resp_rem = torch.where(
        t_exact, 0,
        torch.where(t_over, torch.where(drain_b, 0, rl_rem_base),
                    torch.where(t_dec, t_rem1 - h, rl_rem_base)),
    )

    tn_expire = torch.where(greg_b, r["greg_exp"], r_created + r_dur)
    tn_over = h > limit
    tn_rem = torch.where(tn_over, limit, limit - h)
    tn_resp_status = tn_over.to(torch.int64)

    # -------- leaky bucket (algorithms.go:260-493) --------
    burst = torch.where(r["burst"] == 0, limit, r["burst"])
    burst_f = burst.to(f64)
    leak_exist = exists & algo_match

    b_rem0 = torch.where(reset_b, burst_f, s["remaining_f"])
    burst_changed = s["burst"] != burst
    b_rem1 = torch.where(burst_changed & (burst > trunc_i64(b_rem0)),
                         burst_f, b_rem0)
    rate = torch.where(greg_b, r["greg_dur"], r_dur).to(f64) / safe_limit_f
    duration_eff = torch.where(greg_b, r["greg_exp"] - now, r_dur)
    elapsed = r_created - s["updated_at"]
    leak = elapsed.to(f64) / torch.where(rate == 0, 1.0, rate)
    leaked = trunc_i64(leak) > 0
    b_rem2 = torch.where(leaked, b_rem1 + leak, b_rem1)
    b_upd = torch.where(leaked, r_created, s["updated_at"])
    b_rem3 = torch.where(trunc_i64(b_rem2) > burst, burst_f, b_rem2)

    rem_i = trunc_i64(b_rem3)
    rate_i = trunc_i64(rate)
    h_f = h.to(f64)
    l_at_zero = (rem_i == 0) & (h > 0)
    l_exact = ~l_at_zero & (rem_i == h)
    l_over = ~l_at_zero & ~l_exact & (h > rem_i)
    l_query = ~l_at_zero & ~l_exact & ~l_over & (h == 0)
    l_dec = ~l_at_zero & ~l_exact & ~l_over & ~l_query

    le_remf = torch.where(
        l_exact, 0.0,
        torch.where(l_over, torch.where(drain_b, 0.0, b_rem3),
                    torch.where(l_dec, b_rem3 - h_f, b_rem3)),
    )
    le_resp_status = (l_at_zero | l_over).to(torch.int64)
    le_resp_rem = torch.where(
        l_exact, 0,
        torch.where(l_over, torch.where(drain_b, 0, rem_i),
                    torch.where(l_dec, trunc_i64(b_rem3 - h_f), rem_i)),
    )
    le_reset_rem = torch.where(l_over, rem_i, le_resp_rem)
    le_resp_reset = r_created + (limit - le_reset_rem) * rate_i
    le_expire = torch.where(h != 0, r_created + duration_eff, s["expire_at"])

    ln_rate_i = trunc_i64(r_dur.to(f64) / safe_limit_f)
    ln_duration = torch.where(greg_b, r["greg_exp"] - now, r_dur)
    ln_over = h > burst
    ln_remf = torch.where(ln_over, 0.0, (burst - h).to(f64))
    ln_resp_rem = torch.where(ln_over, 0, burst - h)
    ln_resp_reset = r_created + (limit - ln_resp_rem) * ln_rate_i
    ln_resp_status = ln_over.to(torch.int64)
    ln_expire = r_created + ln_duration

    # -------- algorithm zoo, folded per lane --------
    is_zoo = r["algorithm"] >= ZOO_MIN
    zs, zr = zoo_table.zoo_transitions(
        zoo_table.TorchOps, s, r, exists, reset_b, drain_b)

    def zsel(zoo_v, legacy_v):
        return torch.where(is_zoo, zoo_v, legacy_v)

    def sel(tr, te, tn, le, ln):
        """token-reset / token-exist / token-new / leaky-exist / leaky-new."""
        tok = torch.where(tok_reset, tr, torch.where(tok_exist, te, tn))
        lk = torch.where(leak_exist, le, ln)
        return torch.where(is_token, tok, lk)

    zero = torch.zeros_like(h)
    one = torch.ones_like(h)
    s_remf = s["remaining_f"]
    new_state = {
        "algorithm": zsel(
            r["algorithm"],
            torch.where(is_token, int(Algorithm.TOKEN_BUCKET),
                        int(Algorithm.LEAKY_BUCKET))),
        "limit": limit,
        "remaining": zsel(
            zs.remaining,
            sel(zero, te_rem, tn_rem, s["remaining"], s["remaining"])),
        "remaining_f": zsel(
            torch.zeros_like(s_remf),
            sel(s_remf * 0, s_remf, s_remf, le_remf, ln_remf)),
        "duration": zsel(r_dur, sel(zero, r_dur, r_dur, r_dur, ln_duration)),
        "created_at": zsel(
            zs.created_at,
            sel(zero, t_created, r_created, s["created_at"], s["created_at"])),
        "updated_at": zsel(
            r_created,
            sel(zero, s["updated_at"], s["updated_at"], b_upd, r_created)),
        "burst": zsel(r["burst"], sel(zero, s["burst"], s["burst"], burst, burst)),
        "status": zsel(
            zs.status,
            sel(zero, te_status, zero + UNDER, s["status"], zero + UNDER)),
        "expire_at": zsel(
            zs.expire_at,
            sel(zero, t_expire, tn_expire, le_expire, ln_expire)),
        "in_use": zsel(one, sel(zero, one, one, one, one)),
        "tat": zsel(zs.tat, zero),
        "prev_count": zsel(zs.prev_count, zero),
    }
    resp = {
        "status": zsel(
            zr.status,
            sel(zero + UNDER, te_resp_status, tn_resp_status, le_resp_status,
                ln_resp_status)),
        "remaining": zsel(
            zr.remaining,
            sel(limit, te_resp_rem, tn_rem, le_resp_rem, ln_resp_rem)),
        "reset_time": zsel(
            zr.reset_time,
            sel(zero, rl_reset, tn_expire, le_resp_reset, ln_resp_reset)),
        "over_limit": zsel(
            zr.over_limit,
            sel(torch.zeros_like(exists), t_at_zero | t_over, tn_over,
                l_at_zero | l_over, ln_over)),
    }
    return new_state, resp


def merged_fold(now, new_state: Dict[str, torch.Tensor],
                r: Dict[str, torch.Tensor], count: torch.Tensor):
    """Fold ``count - 1`` followers identical to the head into the head's
    post-transition state (the plain version of ``merged_fold`` in
    ``csrc/transition.cuh``).

    Port of the result of ``transition32.merged_fold32``: the followers at
    rank i <= q = max(base, 0) // h decrement, the rest are over the limit;
    token status flips to OVER on an at-zero step; leaky ``remaining_f``
    zeroes exactly on an exact-remainder or drain step and otherwise loses
    ``min(count - 1, q) * h``.  ``count == 1`` is the identity.  Leaky
    ``base`` is ``floor(remaining_f)`` and ``rate_i`` the exact integer
    ``max(duration, 0) // safe_limit``, as in merged_fold32 (the x64
    ``engine._merged_formulas`` truncates both instead).

    Returns ``(folded, head)``: the state to store, and the head extras
    the member expansion needs (``base``, ``q``, ``rate_i``, ``s0``,
    ``expire``)."""
    is_tok = r["algorithm"] == int(Algorithm.TOKEN_BUCKET)
    h = torch.where(r["hits"] > 0, r["hits"], 1)
    remf = new_state["remaining_f"]
    base = torch.where(is_tok, new_state["remaining"],
                       trunc_i64(torch.floor(remf)))
    q = torch.div(base.clamp_min(0), h, rounding_mode="floor")
    li = count.to(torch.int64) - 1
    alive = now <= new_state["expire_at"]
    legacy = r["algorithm"] <= int(Algorithm.LEAKY_BUCKET)
    fold = (li > 0) & alive & (r["valid"] != 0) & legacy

    residue = base - q * h
    divisible = residue == 0
    drain = (r["behavior"] & int(Behavior.DRAIN_OVER_LIMIT)) != 0
    rem_last = torch.where(li <= q, base - li * h,
                           torch.where(drain, 0, residue))
    at_zero_last = torch.where(divisible, li > q, drain & (li > q + 1))
    zero_f = (((q >= 1) & divisible & (li >= q))
              | ((base > 0) & drain & (li > q)))
    remf_last = torch.where(
        zero_f, 0.0, remf - (torch.minimum(li, q) * h).to(torch.float64))
    safe_limit = torch.where(r["limit"] == 0, 1, r["limit"])
    rate_i = torch.div(r["duration"].clamp_min(0), safe_limit,
                       rounding_mode="floor")

    folded = dict(new_state)
    folded["remaining"] = torch.where(fold & is_tok, rem_last,
                                      new_state["remaining"])
    folded["status"] = torch.where(fold & is_tok & at_zero_last, OVER,
                                   new_state["status"])
    folded["remaining_f"] = torch.where(fold & ~is_tok, remf_last, remf)
    head = {"base": base, "q": q, "rate_i": rate_i,
            "s0": new_state["status"], "expire": new_state["expire_at"]}
    return folded, head


# ----------------------------------------------------------------------
# The x64 closed-form fold of the mesh engine's duplicate windows
# ----------------------------------------------------------------------
NO_MERGE = int(Behavior.RESET_REMAINING | Behavior.DURATION_IS_GREGORIAN)


def merged_formulas(new_state: Dict[str, torch.Tensor],
                    resp: Dict[str, torch.Tensor], r: Dict[str, torch.Tensor],
                    now, rank: torch.Tensor, last_rank: torch.Tensor,
                    fold_mask: torch.Tensor, head_mask: torch.Tensor,
                    R0: torch.Tensor, F0: torch.Tensor, S0: torch.Tensor,
                    E: torch.Tensor):
    """The closed-form duplicate fold of the TPU package's x64 tick
    (``engine._merged_formulas``), in plain int64/float64 torch ops.

    ``R0/F0/S0/E`` are each lane's group head's post-transition
    remaining, remaining_f, status and expire_at; ``rank`` is the lane's
    distance from its head and ``last_rank`` that of its group's last
    member.  Lanes in ``fold_mask`` whose head is alive (``now <= E``) are
    *merged*: rank i answers UNDER with ``base - i*h`` while ``i <= q``,
    else OVER with the drained or residual remaining.  Heads in
    ``head_mask`` (alive) take the group-final remaining, status or
    remaining_f.  Returns ``(rows, resp, merged)``: ``new_state`` with the
    head rows folded, ``resp`` with the merged lanes' answers, and the
    merged mask.

    This is not the parts fold (:func:`merged_fold`, which the grouped and
    layered plans of the single-card engine follow): the leaky ``base``
    truncates ``remaining_f`` instead of flooring it, ``q = base // h``
    divides the signed base instead of clamping it at 0, and ``rate_i`` is
    the truncated float64 quotient ``duration / limit``, as in the JAX
    mesh engine's duplicate path."""
    f64 = torch.float64
    is_tok = r["algorithm"] == int(Algorithm.TOKEN_BUCKET)
    n0 = trunc_i64(F0)
    alive = now <= E
    merged = fold_mask & alive

    h = torch.where(r["hits"] > 0, r["hits"], 1)
    i = rank.to(torch.int64)
    base = torch.where(is_tok, R0, n0)
    q = torch.div(base, h, rounding_mode="floor")
    drain = (r["behavior"] & int(Behavior.DRAIN_OVER_LIMIT)) != 0
    under = i <= q
    residue = base - q * h
    rem_over = torch.where(drain, 0, residue)
    rem_resp = torch.where(under, base - i * h, rem_over)
    safe_limit = torch.where(r["limit"] == 0, 1, r["limit"])
    rate_i = trunc_i64(r["duration"].to(f64) / safe_limit.to(f64))
    reset_rem = torch.where(
        under, rem_resp, torch.where(drain & (i > q + 1), 0, residue))
    leaky_reset = r["created_at"] + (r["limit"] - reset_rem) * rate_i
    resp = {
        "status": torch.where(
            merged, torch.where(under, torch.where(is_tok, S0, UNDER), OVER),
            resp["status"]),
        "remaining": torch.where(merged, rem_resp, resp["remaining"]),
        "reset_time": torch.where(
            merged, torch.where(is_tok, E, leaky_reset), resp["reset_time"]),
        "over_limit": torch.where(merged, ~under, resp["over_limit"]),
    }

    li = last_rank.to(torch.int64)
    rem_last = torch.where(li <= q, base - li * h, rem_over)
    divisible = residue == 0
    at_zero_last = torch.where(divisible, li > q, drain & (li > q + 1))
    status_last = torch.where(at_zero_last, OVER, S0)
    zero_f = (((q >= 1) & divisible & (li >= q))
              | ((base > 0) & drain & (li > q)))
    remf_last = torch.where(
        zero_f, 0.0, F0 - (torch.minimum(li, q) * h).to(f64))
    head_ovr = head_mask & alive
    rows = dict(new_state)
    rows["remaining"] = torch.where(head_ovr & is_tok, rem_last,
                                    new_state["remaining"])
    rows["status"] = torch.where(head_ovr & is_tok, status_last,
                                 new_state["status"])
    rows["remaining_f"] = torch.where(head_ovr & ~is_tok, remf_last,
                                      new_state["remaining_f"])
    return rows, resp, merged


def merge_eligible(r: Dict[str, torch.Tensor], rank: torch.Tensor,
                   head_idx: torch.Tensor,
                   seg_id: torch.Tensor) -> torch.Tensor:
    """(B,) bool: the lanes whose group folds in closed form (the request
    half of ``engine._apply_merged_followers``).  A lane is eligible when
    it is valid, identical to its head (hits, limit, duration, behavior,
    created_at, burst, algorithm), has hits > 0, no RESET_REMAINING or
    Gregorian behavior, is known (heads are exempt), and is a token or
    leaky lane; a group folds only when every valid member is eligible."""
    def same(f):
        return r[f] == r[f][head_idx]

    valid = r["valid"] != 0
    ok = (valid & same("hits") & same("limit") & same("duration")
          & same("behavior") & same("created_at") & same("burst")
          & same("algorithm") & (r["hits"] > 0)
          & ((r["behavior"] & NO_MERGE) == 0)
          & ((r["known"] != 0) | (rank == 0))
          & (r["algorithm"] <= int(Algorithm.LEAKY_BUCKET)))
    bad = torch.zeros(rank.shape[0], dtype=torch.int64, device=rank.device)
    bad.index_add_(0, seg_id, (valid & ~ok).to(torch.int64))
    return ok & (bad[seg_id] == 0)


def apply_merged_followers(new_state: Dict[str, torch.Tensor],
                           resp: Dict[str, torch.Tensor],
                           r: Dict[str, torch.Tensor], now,
                           rank: torch.Tensor, group_size: torch.Tensor,
                           head_idx: torch.Tensor, eligible: torch.Tensor):
    """Port of ``engine._apply_merged_followers``: fold the followers of
    every group whose lanes are ``eligible`` (:func:`merge_eligible`)
    against the post-transition state of their head,
    ``new_state[head_idx]``.  Returns :func:`merged_formulas`'s
    ``(rows, resp, merged)``."""
    return merged_formulas(
        new_state, resp, r, now, rank, group_size - 1,
        fold_mask=eligible & (rank > 0),
        head_mask=eligible & (rank == 0) & (group_size > 1),
        R0=new_state["remaining"][head_idx],
        F0=new_state["remaining_f"][head_idx],
        S0=new_state["status"][head_idx],
        E=new_state["expire_at"][head_idx])
