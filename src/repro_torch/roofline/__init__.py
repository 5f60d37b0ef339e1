"""Roofline analysis of the port's programs on the H100, after
``repro.roofline``: the card's constants and the roofline terms
(``hw``), the op counter that takes the place of the HLO cost analysis
(``op_cost``), the kernels' work by formula (``kernel_work``), and the
reference's helpers over a count (``analysis``)."""
from . import analysis, hw, kernel_work, op_cost
from .analysis import (collective_bytes, collective_op_counts, cost_dict,
                       memory_stats, model_flops)
from .hw import CHIP, H100, roofline_terms

__all__ = ["analysis", "hw", "kernel_work", "op_cost", "collective_bytes",
           "collective_op_counts", "cost_dict", "memory_stats",
           "model_flops", "CHIP", "H100", "roofline_terms"]
