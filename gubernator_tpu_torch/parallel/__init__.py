"""The sharded serving table on one card (port of ``gubernator_tpu.parallel``)."""
