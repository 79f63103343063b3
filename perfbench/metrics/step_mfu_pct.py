"""The whole step's share of the card's peak over the traced steps: model
FLOPs (``perfbench/counts/<family>.py``) over the device's span of those
steps (the first device op's start to the last one's end, from the
trace), as a share of the dense bf16 peak.  It bounds every kernel's
roofline share from above in the step's terms: a kernel taken off the
path leaves its roofline silent, this one not."""
import importlib

from perfbench.peaks import peaks_of

WRAPS = ()
BACKWARD_NODES = ()


def read(trace):
    span = trace.device_span_s
    if not trace.steps or span <= 0:
        return None
    conf = trace.cell.config
    counts = importlib.import_module(f"perfbench.counts.{conf['family']}")
    flops = counts.model_flops(conf, trace.cell.traffic) * trace.steps
    return 100.0 * flops / span / peaks_of(trace.device_kind)["bf16_flops"]
