"""Container healthcheck probe:
``python -m gubernator_tpu_torch.cmd.healthcheck``.

The port's copy of the JAX package's probe, itself the reference's
``cmd/healthcheck/main.go``: GET /v1/HealthCheck on the local daemon,
exit 2 unless it reports healthy — suitable as a container HEALTHCHECK
command.

``--ready`` probes /readyz instead (readiness, not liveness): exit 2
while the daemon is still restoring its snapshot or graceful-draining —
the flag a k8s readinessProbe exec command should use so traffic routes
only to nodes that want it (docs/persistence.md).
"""

from __future__ import annotations

import json
import sys
import urllib.error
import urllib.request

from gubernator_tpu_torch.config import env_knob


def main(argv=None) -> int:
    # Manual flag scan, not argparse: the probe is also called in-process
    # (tests, embedding) where sys.argv belongs to someone else and must
    # not be *parsed* — but the console-script entry point passes no
    # argv, so the literal flag is still honored from the command line.
    ready_probe = "--ready" in (sys.argv[1:] if argv is None else argv)

    # Prefer the no-mTLS status listener when configured: under
    # GUBER_TLS_CLIENT_AUTH the main gateway rejects cleartext probes,
    # which is exactly what GUBER_STATUS_HTTP_ADDRESS exists for.
    # Registry reads (config.env_knob): config touches no device.
    addr = env_knob("GUBER_STATUS_HTTP_ADDRESS") or env_knob(
        "GUBER_HTTP_ADDRESS", "localhost:80"
    )
    path = "/readyz" if ready_probe else "/v1/HealthCheck"
    url = f"http://{addr}{path}"
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            body = json.loads(resp.read())
    except urllib.error.HTTPError as e:
        # The daemon answers 503 with a JSON body when unhealthy (e.g. a
        # majority of peers behind open circuit breakers) or not ready
        # (restoring / draining) — surface its message, not the bare
        # HTTP error.
        try:
            body = json.loads(e.read())
        except Exception:
            print(f"healthcheck failed: {e}", file=sys.stderr)
            return 2
    except Exception as e:
        print(f"healthcheck failed: {e}", file=sys.stderr)
        return 2
    if ready_probe:
        if not body.get("ready"):
            state = "draining" if body.get("draining") else "starting"
            print(f"not ready: {state}", file=sys.stderr)
            return 2
        print("ready")
        return 0
    if body.get("status") != "healthy":
        print(f"unhealthy: {body.get('message', '')}", file=sys.stderr)
        return 2
    print("healthy")
    return 0


if __name__ == "__main__":
    sys.exit(main())
