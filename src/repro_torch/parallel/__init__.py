"""The port's parallelism: gradient compression so far."""
