"""Runtime supervision: crash-safe loops over checkpoints, straggler
monitoring, elastic plans."""
