"""LR schedules (pure functions of the step), as Python floats."""
from __future__ import annotations

import math


def linear_warmup(step: int, warmup_steps: int) -> float:
    return min(1.0, (step + 1.0) / max(1, warmup_steps))


def cosine_schedule(step: int, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> float:
    warm = linear_warmup(step, warmup_steps)
    prog = min(1.0, max(0.0, (step - warmup_steps)
                        / max(1, total_steps - warmup_steps)))
    return warm * (min_ratio
                   + (1.0 - min_ratio) * 0.5 * (1.0 + math.cos(math.pi * prog)))
