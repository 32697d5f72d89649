"""Crash-proof wrapper for background loops.

A background loop that dies silently is worse than one that fails loudly:
a dead ``_hits_loop`` stops GLOBAL reconciliation forever while requests
keep being answered from increasingly stale local state.
:func:`spawn_supervised` wraps a loop coroutine so an unexpected exception
is logged, counted (``gubernator_loop_restarts``), and followed by a
restart after a short doubling delay — the loop is only ever *gone* when
it returns cleanly, is cancelled, or its owner says it should stop.

The port's copy of the JAX package's ``resilience/supervisor.py``:
the same behavior and on-disk format, pure host code (numpy), with
plain ``threading`` locks.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from typing import Awaitable, Callable, Optional

log = logging.getLogger("gubernator.resilience")


def spawn_supervised(
    factory: Callable[[], Awaitable[None]],
    *,
    name: str,
    should_restart: Callable[[], bool] = lambda: True,
    metrics=None,
    loop_label: Optional[str] = None,
    restart_delay: float = 0.01,
    max_delay: float = 1.0,
) -> asyncio.Task:
    """Run ``factory()`` as a task that restarts on crash.

    ``should_restart`` is consulted after every crash (owners pass their
    running/closed flag); ``metrics.loop_restarts`` (labeled
    ``loop=loop_label``) counts restarts when a registry is wired.
    """

    async def run() -> None:
        delay = restart_delay
        while True:
            try:
                await factory()
                return  # clean exit
            except asyncio.CancelledError:
                raise
            except Exception:
                if not should_restart():
                    return
                log.exception(
                    "background loop %r crashed; restarting in %.3fs",
                    name, delay,
                )
                if metrics is not None:
                    metrics.loop_restarts.labels(
                        loop=loop_label or name
                    ).inc()
                await asyncio.sleep(delay)
                delay = min(delay * 2, max_delay)

    return asyncio.create_task(run(), name=name)


def spawn_supervised_thread(
    target: Callable[[], None],
    *,
    name: str,
    should_restart: Callable[[], bool] = lambda: True,
    metrics=None,
    loop_label: Optional[str] = None,
    restart_delay: float = 0.01,
    max_delay: float = 1.0,
) -> threading.Thread:
    """Thread twin of :func:`spawn_supervised` for loops that must run
    off the event loop entirely (blocking file I/O: the SSD tier's slab
    writer).  Same contract: restart on crash with a doubling delay,
    gone only on clean return, ``should_restart()`` False, or process
    exit (the thread is a daemon).
    """

    def run() -> None:
        delay = restart_delay
        while True:
            try:
                target()
                return  # clean exit
            except Exception:
                if not should_restart():
                    return
                log.exception(
                    "background thread %r crashed; restarting in %.3fs",
                    name, delay,
                )
                if metrics is not None:
                    metrics.loop_restarts.labels(
                        loop=loop_label or name
                    ).inc()
                time.sleep(delay)
                delay = min(delay * 2, max_delay)

    thread = threading.Thread(target=run, name=name, daemon=True)
    thread.start()
    return thread
