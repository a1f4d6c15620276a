"""Several processes, one per device: process groups, the GPipe
pipeline and the multi-rank self-test."""
