from .archs import (ACCEL_ARCHS, ARCHS, ZOO_ARCHS, get_config, smoke_config,
                    zoo_validation_report)
from .paper_workloads import (all_workloads, arch_gemms,
                              banded_attention_workloads,
                              by_name, conv_workloads, mm_workloads,
                              structured_workloads)
from .shapes import LONG_CONTEXT_ARCHS, SHAPES, all_cells, applicable
