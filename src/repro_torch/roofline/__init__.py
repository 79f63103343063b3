"""Roofline terms of the port (``repro/roofline/`` counterpart): the
three-term report of a dry run (``roofline_report``, fed the dry mesh's
per-opcode collective bytes where the reference parses HLO text), the
memory model the plan bridge and the dry run read, and the model-FLOP
count."""
from .analysis import (HBM_BW, LINK_BW, PEAK_FLOPS, MemoryModel,
                       RooflineReport, model_flops, modeled_memory,
                       roofline_report)

__all__ = ["HBM_BW", "LINK_BW", "MemoryModel", "PEAK_FLOPS",
           "RooflineReport", "model_flops", "modeled_memory",
           "roofline_report"]
