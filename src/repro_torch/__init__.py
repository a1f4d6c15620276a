"""PyTorch/CUDA port of the SparseMap reproduction (the JAX package
``repro`` is the reference; this package imports neither it nor jax)."""
