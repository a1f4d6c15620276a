"""Hand-written CUDA kernels for the perf-critical ops: block-sparse SpMM
(SparseMap's Skip at tile granularity) and blocked flash attention.
Importing this package builds nothing and needs neither nvcc nor a GPU;
the kernels are compiled at their first launch."""
