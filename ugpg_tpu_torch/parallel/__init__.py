"""Device-level parallelism of the port: the uncertainty pipeline."""
