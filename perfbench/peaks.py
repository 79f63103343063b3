"""Published peaks of the cards the benchmark runs on (NVIDIA's H100 SXM
data sheet: dense bf16 tensor-core rate without sparsity, HBM3 bandwidth),
at the card's full power limit of 700 W; a run prints the limit it found
beside them."""
from __future__ import annotations

from typing import Dict

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12},
}


def peaks_of(kind: str) -> Dict[str, float]:
    """The peaks of a card by ``torch.cuda.get_device_name()``; raises for
    a card the table does not hold (no guessed peak)."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r} in "
                       "perfbench/peaks.py")
    return PEAKS[kind]


def least_seconds(ops: float, nbytes: float, kind: str) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 rate and the bytes over the HBM rate."""
    p = peaks_of(kind)
    return max(ops / p["bf16_flops"], nbytes / p["hbm_bytes_s"])
