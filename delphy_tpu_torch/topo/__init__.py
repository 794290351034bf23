"""Host topology layer of the port: the SPR machinery (graft, study,
history, site deltas), partitioning, the augmented coalescent prior, branch
reform and the topology bursts, on the native kernel or, without it, on the
Python ``TopologyMixer`` (the reference package's fallback)."""

from .mixer import TopologyMixer  # noqa: F401
