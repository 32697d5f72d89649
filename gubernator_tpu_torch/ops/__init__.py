"""Device-side operations of the port: the row table, the fused tick and
the engine that drives them."""
