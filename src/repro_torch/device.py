"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device`` with a CUDA index made
    explicit; raise if it is a CUDA device and no CUDA device is available
    (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU")
    # "cuda" names the current device; tensors report it with its index
    return dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())
