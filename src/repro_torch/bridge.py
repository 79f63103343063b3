"""Weights of the JAX package -> the port's model.

``params_from_jax`` takes the JAX ``init_lm`` pytree with every leaf given as
a numpy array (``jax.tree.map(np.asarray, params)``) and builds the port's
:class:`~repro_torch.models.transformer.LM` with the same numbers.  The JAX
package stacks the L blocks of a segment along a leading layer axis
(``repro/models/transformer.py``: ``params["stacks"][i]`` holds ``(L, ...)``
leaves); they are unstacked here into one module per block.  bfloat16 is
moved bit for bit: the numpy array (dtype ``bfloat16`` from ``ml_dtypes``,
which this module does not import) is viewed as int16 and the torch tensor
viewed back as ``torch.bfloat16``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention
from repro_torch.models.common import ModelConfig
from repro_torch.models.mlp import SwiGLU
from repro_torch.models.ssm import SSM
from repro_torch.models.transformer import (LM, DenseBlock, SSMBlock,
                                            build_stacks)


def tensor_from_numpy(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Exact copy of a numpy array (bfloat16 included) as a torch tensor."""
    arr = np.array(arr, order="C")      # a writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig, *,
                    device: torch.device = "cuda") -> LM:
    """The port's model holding the weights of a JAX ``init_lm`` pytree."""
    ((kind, n),) = build_stacks(cfg)
    dev = resolve_device(device)

    def t(a: np.ndarray) -> torch.Tensor:
        return tensor_from_numpy(a, dev)

    (stack,) = tree["stacks"]           # one segment of L blocks
    blocks = []
    for i in range(n):
        if kind == "ssm":
            blocks.append(SSMBlock(t(stack["ln1"][i]), SSM(
                **{k: t(v[i]) for k, v in stack["ssm"].items()})))
            continue
        attn: Dict[str, torch.Tensor] = {k: t(v[i])
                                         for k, v in stack["attn"].items()}
        mlp = stack["mlp"]
        blocks.append(DenseBlock(
            t(stack["ln1"][i]),
            Attention(attn.pop("wq"), attn.pop("wk"), attn.pop("wv"),
                      attn.pop("wo"), **attn),
            t(stack["ln2"][i]),
            SwiGLU(t(mlp["w_gate"][i]), t(mlp["w_up"][i]),
                   t(mlp["w_down"][i]))))
    head = tree.get("head")
    return LM(t(tree["embed"]), blocks, t(tree["final_norm"]),
              None if head is None else t(head))
