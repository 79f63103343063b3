"""Flash attention's share of its roofline: the summed least time of every
call of ``kernels/ops.py::flash_attention`` and of its backward
(``perfbench/counts/attention.py``) over the device time inside those
calls' ranges and ``FlashAttentionBackward``'s."""
from perfbench.counts.attention import call_cost
from perfbench.trace import roofline_pct

WRAPS = (("repro_torch.kernels.ops", "flash_attention"),)
BACKWARD_NODES = ("FlashAttentionBackward",)


def read(trace):
    return roofline_pct(trace, "flash_attention", "FlashAttentionBackward",
                        call_cost)
