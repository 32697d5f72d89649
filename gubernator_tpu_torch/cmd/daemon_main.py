"""Server entry point: ``python -m gubernator_tpu_torch.cmd.daemon_main``.

The port's copy of the JAX package's daemon entry (the reference's
``cmd/gubernator/main.go``): two flags (``-config``, ``-debug``),
env-first configuration, SIGTERM/SIGINT graceful shutdown.  A standalone
node serves on the card; ``GUBER_TPU_PLATFORM=cpu`` serves on a host
without one.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
import sys

from gubernator_tpu_torch.config import setup_daemon_config
from gubernator_tpu_torch.transport.daemon import spawn_daemon


async def run(config_file: str) -> None:
    conf = setup_daemon_config(config_file)
    level = getattr(logging, conf.log_level.upper(), logging.INFO)
    if conf.log_format == "json":
        logging.basicConfig(
            level=level,
            format='{"time":"%(asctime)s","level":"%(levelname)s",'
            '"logger":"%(name)s","message":"%(message)s"}',
        )
    else:
        logging.basicConfig(level=level)
    from gubernator_tpu_torch.version import banner

    logging.getLogger("gubernator").info("%s", banner())
    daemon = await spawn_daemon(conf)
    print("Ready", flush=True)  # readiness marker

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()

    def _on_signal(signame: str) -> None:
        logging.getLogger("gubernator").info(
            "received %s: draining (readiness -> 503, final snapshot)",
            signame,
        )
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, _on_signal, sig.name)
    await stop.wait()
    # Graceful drain (docs/persistence.md): close flips /readyz to 503,
    # writes the final base snapshot, then stops the listeners.
    await daemon.close()
    logging.getLogger("gubernator").info("drain complete; exiting")


def main(argv=None) -> int:
    from gubernator_tpu_torch.version import banner

    p = argparse.ArgumentParser(description="gubernator-tpu-torch rate-limit daemon")
    p.add_argument("-config", "--config", default="", help="path to a key=value config file")
    p.add_argument("-debug", "--debug", action="store_true", help="debug logging")
    p.add_argument("-version", "--version", action="version", version=banner())
    args = p.parse_args(argv)
    if args.debug:
        import os

        os.environ["GUBER_LOG_LEVEL"] = "debug"
    try:
        asyncio.run(run(args.config))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
