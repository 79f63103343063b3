"""Analytic roofline terms of the port (``repro/roofline/`` counterpart):
the memory model the plan bridge reads and the model-FLOP count.  The
reference's HLO parsing and ``roofline_report`` are JAX-specific and not
ported (``ROADMAP.md`` queue 1)."""
from .analysis import (HBM_BW, PEAK_FLOPS, MemoryModel, model_flops,
                       modeled_memory)

__all__ = ["HBM_BW", "MemoryModel", "PEAK_FLOPS", "model_flops",
           "modeled_memory"]
