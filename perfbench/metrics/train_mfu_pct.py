"""Model FLOPs of the window's steps (``perfbench/counts/<family>.py``) over
its seconds, as a share of the card's published dense bf16 peak."""
from perfbench.peaks import peaks_of


def read(run):
    if not run.steps:
        return None
    rate = run.model_flops * run.steps / run.window_s
    return 100.0 * rate / peaks_of(run.device_kind)["bf16_flops"]
