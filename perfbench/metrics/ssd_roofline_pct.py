"""The SSD scan's share of its roofline: the summed least time of every
call of ``kernels/ops.py::ssd_scan`` and of its backward
(``perfbench/counts/ssd.py``: the recurrence's operations) over the device
time inside those calls' ranges and ``SSDScanBackward``'s."""
from perfbench.counts.ssd import call_cost
from perfbench.trace import roofline_pct

WRAPS = (("repro_torch.kernels.ops", "ssd_scan"),)
BACKWARD_NODES = ("SSDScanBackward",)


def read(trace):
    return roofline_pct(trace, "ssd_scan", "SSDScanBackward", call_cost)
