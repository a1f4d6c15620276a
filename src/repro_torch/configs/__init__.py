from .archs import ACCEL_ARCHS, ZOO_ARCHS, zoo_validation_report
from .paper_workloads import (all_workloads, banded_attention_workloads,
                              by_name, conv_workloads, mm_workloads,
                              structured_workloads)
