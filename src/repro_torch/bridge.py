"""Weights of the JAX package -> the port's model.

``params_from_jax`` takes the JAX ``init_lm`` pytree with every leaf given as
a numpy array (``jax.tree.map(np.asarray, params)``) and builds the port's
:class:`~repro_torch.models.transformer.LM` with the same numbers.  The JAX
package stacks the L blocks of a segment along a leading layer axis
(``repro/models/transformer.py``: ``params["stacks"][i]`` holds ``(L, ...)``
leaves); they are unstacked here into one module per block.  bfloat16 is
moved bit for bit: the numpy array (dtype ``bfloat16`` from ``ml_dtypes``,
which this module does not import) is viewed as int16 and the torch tensor
viewed back as ``torch.bfloat16``.  The hybrid's ``shared_attn`` (``ln``
and an attention block) becomes the model's
:class:`~repro_torch.models.transformer.SharedAttention`.  A key the port
does not map raises, rather than leave a weight behind.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention
from repro_torch.models.common import ModelConfig
from repro_torch.models.mlp import SwiGLU
from repro_torch.models.ssm import SSM
from repro_torch.models.transformer import (LM, DenseBlock, SharedAttention,
                                            SSMBlock, build_stacks)

_BLOCK_KEYS = {"ssm": {"ln1", "ssm"}, "dense": {"ln1", "attn", "ln2", "mlp"}}
_SSM_KEYS = {"in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_w",
             "out_proj"}
_TOP_KEYS = {"embed", "stacks", "final_norm", "head", "shared_attn"}


def tensor_from_numpy(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Exact copy of a numpy array (bfloat16 included) as a torch tensor."""
    arr = np.array(arr, order="C")      # a writable copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _only_keys(tree: Mapping[str, Any], known: set, what: str) -> None:
    extra = set(tree) - known
    if extra:
        raise ValueError(f"the bridge does not map {what} keys "
                         f"{sorted(extra)}")


def _attention(leaves: Mapping[str, torch.Tensor]) -> Attention:
    """An attention block from its JAX leaves (wq, wk, wv, wo, and the
    optional biases and QK-norm weights)."""
    _only_keys(leaves, {"wq", "wk", "wv", "wo", "bq", "bk", "bv", "q_norm",
                        "k_norm"}, "attention")
    a = dict(leaves)
    return Attention(a.pop("wq"), a.pop("wk"), a.pop("wv"), a.pop("wo"), **a)


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig, *,
                    device: torch.device = "cuda") -> LM:
    """The port's model holding the weights of a JAX ``init_lm`` pytree.
    Raises ValueError on a key of the tree it does not map."""
    ((kind, n),) = build_stacks(cfg)
    dev = resolve_device(device)

    def t(a: np.ndarray) -> torch.Tensor:
        return tensor_from_numpy(a, dev)

    _only_keys(tree, _TOP_KEYS, "top-level")
    (stack,) = tree["stacks"]           # one segment of L blocks
    _only_keys(stack, _BLOCK_KEYS[kind], f"{kind} block")
    if kind == "ssm":
        _only_keys(stack["ssm"], _SSM_KEYS, "ssm")
    blocks = []
    for i in range(n):
        if kind == "ssm":
            blocks.append(SSMBlock(t(stack["ln1"][i]), SSM(
                **{k: t(v[i]) for k, v in stack["ssm"].items()})))
            continue
        mlp = stack["mlp"]
        _only_keys(mlp, {"w_gate", "w_up", "w_down"}, "mlp")
        blocks.append(DenseBlock(
            t(stack["ln1"][i]),
            _attention({k: t(v[i]) for k, v in stack["attn"].items()}),
            t(stack["ln2"][i]),
            SwiGLU(t(mlp["w_gate"][i]), t(mlp["w_up"][i]),
                   t(mlp["w_down"][i]))))
    shared = tree.get("shared_attn")
    if shared is not None:
        _only_keys(shared, {"ln", "attn"}, "shared_attn")
        shared = SharedAttention(t(shared["ln"]), _attention(
            {k: t(v) for k, v in shared["attn"].items()}))
    head = tree.get("head")
    return LM(t(tree["embed"]), blocks, t(tree["final_norm"]),
              None if head is None else t(head), shared)
