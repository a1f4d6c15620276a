"""SparseMap core on PyTorch: the paper's contribution.

The counterpart of the JAX package's ``repro.core`` for the search and
its fleet engine: genome encoding, sensitivity analysis, the evolution
strategy, the baselines and the numpy cost oracle carried over as numpy
code, and the batched row cost evaluator (``torch_cost``) as a PyTorch
tensor program that runs on the GPU unless the caller asks for the CPU.

  workload     — sparse tensor workloads (einsum-like SpMM / SpConv)
  accel        — hardware platforms (edge / mobile / cloud, Table II)
  arch         — declarative accelerator topology (ArchSpec)
  mapping      — loop-nest mappings (tiling + permutation + spatial)
  sparse       — sparse strategies (compression formats + Skip/Gate)
  cost_model   — reference cost model (energy, latency, validity, EDP)
  encoding     — the paper's prime-factor + sparse-strategy gene encoding
  torch_cost   — vectorized PyTorch batch evaluator (population-parallel),
                 mega-batched dispatch and device-resident ES segments
  search       — run(method, workload, platform) + MultiSearch / run_sweep /
                 run_method_sweep for concurrent fleets of searches
  sensitivity  — gene sensitivity analysis (Fig. 10)
  evolution    — customized ES: HSHI, annealing mutation, SA crossover
  baselines    — random-pruned, PSO, MCTS, TBPSA, PPO, DQN, SAGE-like
"""
from . import accel, workload
from .arch import ARCH_SPARSEMAP, ArchSpec, StorageLevel, as_arch
from .cost_model import CostReport, Design, evaluate
from .encoding import GenomeSpec
from .evolution import ESConfig, SearchResult, evolve
from .search import MultiSearch, SearchTask, run_sweep
from .torch_cost import TorchCostModel
from .workload import Workload, batched_spmm, spconv, spmm
