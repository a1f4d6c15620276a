"""Entry points: ``python -m repro_torch.launch.serve decode`` (the LM
serving loop) and ``python -m repro_torch.launch.serve sweep`` (the sweep
server)."""
