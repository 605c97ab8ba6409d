"""Copies of ``repro.core``'s jax-free modules for the port (numpy only):
the P-chase contract and measurement methods, the cache simulator and
device registry, and the laws and cost model that size the serving
engine's pages."""
