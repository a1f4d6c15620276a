"""Entry points: ``python -m repro_torch.launch.serve decode`` (the LM
serving loop), ``python -m repro_torch.launch.serve sweep`` (the sweep
server) and ``python -m repro_torch.launch.train`` (training, over a
mesh of processes with ``--mesh``)."""
