"""Weights of the JAX package <-> the port's model.

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

The other way, :func:`tree_from_params` gives the JAX tree of a port model
(numpy leaves, each block's leaf stacked on a leading L axis), and
:func:`flat_from_leaves` / :func:`assign_flat` map any list aligned with
``model.parameters()`` (the parameters, their gradients, AdamW's
``master``, ``m`` and ``v``) to and from the JAX tree's flattened paths
(``stacks/0/attn/wq``), which the checkpoint store writes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

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


# --------------------------------------------------------------------------
# the port's model -> the JAX tree
# --------------------------------------------------------------------------

def jax_path(name: str) -> Tuple[str, Optional[int]]:
    """The JAX tree path of a port parameter name and its layer index:
    ``blocks.3.attn.wq`` -> (``stacks/0/attn/wq``, 3); ``shared_attn.ln`` ->
    (``shared_attn/ln``, None)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return "/".join(["stacks", "0", *parts[2:]]), int(parts[1])
    return "/".join(parts), None


def flat_from_leaves(model: nn.Module, leaves: Sequence[torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """``leaves`` aligned with ``model.parameters()`` -> {JAX tree path:
    host tensor}, each block's leaf stacked on a leading L axis in layer
    order, dtypes kept."""
    named = [n for n, _ in model.named_parameters()]
    if len(named) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for {len(named)} parameters")
    groups: Dict[str, List[Tuple[Optional[int], torch.Tensor]]] = {}
    for name, leaf in zip(named, leaves):
        path, layer = jax_path(name)
        groups.setdefault(path, []).append((layer, leaf.detach().cpu()))
    out = {}
    for path, items in groups.items():
        layers = [layer for layer, _ in items]
        if layers == [None]:
            out[path] = items[0][1]
        elif layers == list(range(len(items))):
            out[path] = torch.stack([t for _, t in items])
        else:
            raise ValueError(f"{path}: layers {layers} are not 0..L-1")
    return out


def assign_flat(model: nn.Module, targets: Sequence[torch.Tensor],
                flat: Mapping[str, Any]) -> None:
    """Copy ``flat`` ({JAX tree path: array or tensor, stacked on L}) into
    ``targets`` (aligned with ``model.parameters()``), in place and on the
    targets' devices, cast to their dtypes.  Raises ValueError on a path
    that no target takes or a target that no path fills, and on a shape
    that differs."""
    named = [n for n, _ in model.named_parameters()]
    if len(named) != len(targets):
        raise ValueError(f"{len(targets)} targets for {len(named)} "
                         "parameters")
    used = set()
    with torch.no_grad():
        for name, t in zip(named, targets):
            path, layer = jax_path(name)
            if path not in flat:
                raise ValueError(f"no leaf {path!r} for parameter {name!r}")
            used.add(path)
            src = flat[path]
            src = src if isinstance(src, torch.Tensor) else \
                torch.from_numpy(np.asarray(src))
            if layer is not None:
                src = src[layer]
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{path}: shape {tuple(src.shape)} for "
                                 f"parameter {name!r} of {tuple(t.shape)}")
            t.copy_(src.to(t.dtype))
    extra = set(flat) - used
    if extra:
        raise ValueError(f"the port does not map leaves {sorted(extra)}")


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """{``a/0/b``: leaf} -> {"a": [{"b": leaf}]}: a path component that is
    a digit indexes a list, as in the JAX tree's ``stacks``."""
    root: Dict[str, Any] = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node: Any = root
        for here, nxt in zip(parts[:-1], parts[1:]):
            key = int(here) if here.isdigit() else here
            empty = [] if nxt.isdigit() else {}
            if isinstance(node, list):
                while len(node) <= key:
                    node.append(None)
                node[key] = node[key] if node[key] is not None else empty
            else:
                node.setdefault(key, empty)
            node = node[key]
        node[int(parts[-1]) if parts[-1].isdigit() else parts[-1]] = leaf
    return root


def _numpy_from_tensor(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as numpy; bfloat16 bit for bit as ``ml_dtypes``'
    bfloat16 (imported here only, where it is needed)."""
    t = t.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    import ml_dtypes
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)


def tree_from_params(model: LM) -> Dict[str, Any]:
    """The JAX ``init_lm`` tree of the port's model, the inverse of
    :func:`params_from_jax`: numpy leaves, each block's leaf stacked on a
    leading L axis (``stacks[0]``), bfloat16 bit for bit."""
    flat = flat_from_leaves(model, list(model.parameters()))
    return _nest({k: _numpy_from_tensor(v) for k, v in flat.items()})
