"""Entry points: ``python -m repro_torch.launch.serve sweep`` (the sweep
server)."""
