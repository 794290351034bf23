"""Host topology layer of the port: partitioning, the augmented coalescent
prior, branch reform and the native topology bursts."""
