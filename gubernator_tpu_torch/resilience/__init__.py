"""Crash-proof background loops (the port's copy of the JAX package's
``resilience.supervisor``; the breakers, backoff and fault injection of
that package belong to the service layer and are not ported yet)."""

from gubernator_tpu_torch.resilience.supervisor import (
    spawn_supervised, spawn_supervised_thread)

__all__ = ["spawn_supervised", "spawn_supervised_thread"]
