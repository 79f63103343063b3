"""The one generator of training traffic: batches of token rows drawn from
the seed, as a traffic file's parameters say.

A traffic file holds ``batch`` rows of ``seq`` tokens a step, the law the
token ids follow (``{"law": "zipf", "s": ...}``: rank ``k`` of the
vocabulary drawn with probability proportional to ``k ** -s``, ranks
mapped to ids by a permutation drawn from the seed, so the frequent ids
are spread over the table as in text) and ``distinct_batches``, the
batches made before the window, which the window cycles through.  Each
row holds ``seq + 1`` draws: the tokens are the first ``seq``, the labels
the next tokens.  Every row of every batch is drawn apart, so no two rows
of the first steps are alike.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


def token_law(traffic: Dict[str, Any], vocab: int,
              rng: np.random.Generator):
    """A function ``n -> n`` token ids of the traffic's law."""
    law = traffic["tokens"]
    if law["law"] != "zipf":
        raise ValueError(f"unknown token law {law['law']!r}")
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -float(law["s"])
    cdf = np.cumsum(p / p.sum())
    ids = rng.permutation(vocab)
    return lambda n: ids[np.minimum(np.searchsorted(cdf, rng.random(n)),
                                    vocab - 1)]


def make_batches(traffic: Dict[str, Any], vocab: int,
                 seed: int) -> List[Dict[str, torch.Tensor]]:
    """``distinct_batches`` batches of int64 ``tokens`` and ``labels``
    (batch, seq) on the host, the same for the same seed."""
    rng = np.random.default_rng([seed, 0x7261])
    draw = token_law(traffic, vocab, rng)
    B, S = int(traffic["batch"]), int(traffic["seq"])
    out = []
    for _ in range(int(traffic["distinct_batches"])):
        rows = torch.from_numpy(draw(B * (S + 1)).reshape(B, S + 1)
                                .astype(np.int64))
        out.append({"tokens": rows[:, :S].contiguous(),
                    "labels": rows[:, 1:].contiguous()})
    return out


def tokens_per_batch(traffic: Dict[str, Any]) -> int:
    return int(traffic["batch"]) * int(traffic["seq"])
