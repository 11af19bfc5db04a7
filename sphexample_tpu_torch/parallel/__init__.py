"""Multi-slab execution of the port: the communication context and the slab
sharding of an assembled simulation."""

from .context import SINGLE, CommContext, LocalGroup, run_ranks  # noqa: F401
