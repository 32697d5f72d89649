"""Guardrailed telemetry-driven autoscaler (docs/autoscaling.md).

The port's copy of the JAX package's ``autoscale`` (pure host code).

Closes the loop over live resharding (docs/resharding.md): a supervised
controller samples the admission/latency/occupancy telemetry the system
already produces, feeds it through a sustained-window policy with
non-overlapping hysteresis bands, and drives ``Instance.reshard()``
through hard guardrails — per-direction cooldowns, a rolling-hour flap
suppressor, abort-on-open-breaker, abort-on-reshard-busy, and a dry-run
mode that records every decision without acting.  Every decision lands
in a bounded ring (``/debug/autoscaler``) and in the
``gubernator_tpu_autoscale_*`` counter families, so a misbehaving
controller is diagnosable from the outside.
"""

from __future__ import annotations

from gubernator_tpu_torch.autoscale.controller import Autoscaler, Decision
from gubernator_tpu_torch.autoscale.policy import AutoscalePolicy, PolicyConfig
from gubernator_tpu_torch.autoscale.signals import (
    SignalSnapshot,
    instance_sampler,
)

__all__ = [
    "Autoscaler",
    "AutoscalePolicy",
    "Decision",
    "PolicyConfig",
    "SignalSnapshot",
    "instance_sampler",
]
