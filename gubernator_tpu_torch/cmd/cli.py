"""Synthetic load generator: ``python -m gubernator_tpu_torch.cmd.cli``.

The port's copy of the JAX package's load generator, itself the
reference's ``cmd/gubernator-cli/main.go``: generate a pool of random
token-bucket limits and fire them at a server with bounded concurrency,
reporting throughput and over-limit counts.
"""

from __future__ import annotations

import argparse
import asyncio
import random
import string
import sys
import time

from gubernator_tpu_torch.transport.daemon import DaemonClient
from gubernator_tpu_torch.types import Algorithm, RateLimitRequest, Status


def _rand_key(n: int = 10) -> str:
    return "".join(random.choice(string.ascii_lowercase) for _ in range(n))


async def run(args) -> None:
    limits = [
        RateLimitRequest(
            name=f"gubernator-cli-{i}",
            unique_key=_rand_key(),
            hits=1,
            limit=random.randint(1, 100),
            duration=random.randint(1000, 60_000),
            algorithm=Algorithm.TOKEN_BUCKET,
        )
        for i in range(args.limits)
    ]
    client = DaemonClient(args.address)
    sem = asyncio.Semaphore(args.concurrency)
    stats = {"ok": 0, "over": 0, "err": 0}

    async def one(i: int):
        async with sem:
            r = random.choice(limits)
            try:
                out = await client.get_rate_limits([r], timeout=args.timeout)
            except Exception:
                stats["err"] += 1
                return
            if out[0].error:
                stats["err"] += 1
            elif out[0].status == Status.OVER_LIMIT:
                stats["over"] += 1
            else:
                stats["ok"] += 1

    t0 = time.perf_counter()
    await asyncio.gather(*(one(i) for i in range(args.requests)))
    dt = time.perf_counter() - t0
    await client.close()
    print(
        f"{args.requests} requests in {dt:.2f}s "
        f"({args.requests / dt:,.0f} req/s) — "
        f"ok={stats['ok']} over_limit={stats['over']} errors={stats['err']}"
    )


def main(argv=None) -> int:
    from gubernator_tpu_torch.version import banner

    p = argparse.ArgumentParser(description="gubernator-tpu load generator")
    p.add_argument("--version", action="version", version=banner())
    p.add_argument("--address", default="localhost:81")
    p.add_argument("--limits", type=int, default=2000,
                   help="number of distinct random rate limits")
    p.add_argument("--requests", type=int, default=10_000)
    p.add_argument("--concurrency", type=int, default=128)
    p.add_argument("--timeout", type=float, default=5.0)
    args = p.parse_args(argv)
    asyncio.run(run(args))
    return 0


if __name__ == "__main__":
    sys.exit(main())
