"""Weights of the JAX package <-> the port's model.

``params_from_jax`` takes the JAX ``init_lm`` pytree with every leaf given as
a numpy array (``jax.tree.map(np.asarray, params)``) and builds the port's
:class:`~repro_torch.models.transformer.LM` with the same numbers.  The JAX
package stacks the L blocks of a segment along a leading layer axis
(``repro/models/transformer.py``: ``params["stacks"][i]`` holds ``(L, ...)``
leaves); they are unstacked here into one module per block.  bfloat16 is
moved bit for bit: the numpy array (dtype ``bfloat16`` from ``ml_dtypes``,
which this module does not import) is viewed as int16 and the torch tensor
viewed back as ``torch.bfloat16``.  A MoE model has two segments when its
first blocks are dense (``stacks[0]`` dense, ``stacks[1]`` MoE, each
indexed from 0), one otherwise.  The hybrid's ``shared_attn`` (``ln``
and an attention block) becomes the model's
:class:`~repro_torch.models.transformer.SharedAttention`, and a VLM's
``projector`` (``w1``, ``b1``, ``w2``, ``b2``) its
:class:`~repro_torch.models.embedding.Projector`.  An
encoder-decoder config takes the JAX ``init_encdec`` tree (``enc_pos``,
the stacked ``enc_blocks`` {``ln1``, ``attn``, ``ln2``, ``mlp``},
``enc_ln``, ``embed``, ``dec_pos``, the stacked ``dec_blocks`` {``ln1``,
``self_attn``, ``ln_x``, ``cross_attn``, ``ln2``, ``mlp``}, ``dec_ln``) and
gives :class:`~repro_torch.models.encdec.EncDec`.  A key the port does not
map raises, rather than leave a weight behind.

The other way, :func:`tree_from_params` gives the JAX tree of a port model
(numpy leaves, each block's leaf stacked on a leading L axis), and
:func:`flat_from_leaves` / :func:`assign_flat` map any list aligned with
``model.parameters()`` (the parameters, their gradients, AdamW's
``master``, ``m`` and ``v``) to and from the JAX tree's flattened paths
(``stacks/0/attn/wq``), which the checkpoint store writes.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention
from repro_torch.models.common import ModelConfig
from repro_torch.models.embedding import Projector
from repro_torch.models.encdec import DecBlock, EncBlock, EncDec, LayerNorm
from repro_torch.models.mlp import GeluMLP, SwiGLU
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import SSM
from repro_torch.models.transformer import (LM, DenseBlock, MoEBlock,
                                            SharedAttention, SSMBlock,
                                            build_stacks)

_BLOCK_KEYS = {"ssm": {"ln1", "ssm"}, "dense": {"ln1", "attn", "ln2", "mlp"},
               "moe": {"ln1", "attn", "ln2", "moe"}}
_MOE_KEYS = {"router", "w_gate", "w_up", "w_down", "shared",
             "dense_residual"}
_SSM_KEYS = {"in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_w",
             "out_proj"}
_TOP_KEYS = {"embed", "stacks", "final_norm", "head", "shared_attn",
             "projector"}
_ENCDEC_KEYS = {"enc_pos", "enc_blocks", "enc_ln", "embed", "dec_pos",
                "dec_blocks", "dec_ln"}
_ENC_KEYS = {"ln1", "attn", "ln2", "mlp"}
_DEC_KEYS = {"ln1", "self_attn", "ln_x", "cross_attn", "ln2", "mlp"}
# the encoder-decoder's stacked blocks: their JAX paths carry no segment
_STACKED = ("enc_blocks", "dec_blocks")


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


def _swiglu(leaves: Mapping[str, torch.Tensor], what: str) -> SwiGLU:
    _only_keys(leaves, {"w_gate", "w_up", "w_down"}, what)
    return SwiGLU(leaves["w_gate"], leaves["w_up"], leaves["w_down"])


def _moe(tree: Mapping[str, Any], t: Callable) -> MoE:
    """A MoE FFN from one layer's JAX leaves."""
    _only_keys(tree, _MOE_KEYS, "moe")
    opt = {k: _swiglu({n: t(v) for n, v in tree[k].items()}, f"moe {k}")
           for k in ("shared", "dense_residual") if k in tree}
    return MoE(t(tree["router"]), t(tree["w_gate"]), t(tree["w_up"]),
               t(tree["w_down"]), **opt)


def _layer(tree: Any, i: int) -> Any:
    """Layer ``i`` of a stacked subtree."""
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _layer_norm(tree: Mapping[str, Any], t: Callable, what: str
                ) -> LayerNorm:
    _only_keys(tree, {"w", "b"}, what)
    return LayerNorm(t(tree["w"]), t(tree["b"]))


def _gelu_mlp(tree: Mapping[str, Any], t: Callable) -> GeluMLP:
    _only_keys(tree, {"w_fc", "b_fc", "w_proj", "b_proj"}, "gelu mlp")
    return GeluMLP(t(tree["w_fc"]), t(tree["b_fc"]), t(tree["w_proj"]),
                   t(tree["b_proj"]))


def _encdec_from_jax(tree: Mapping[str, Any], cfg: ModelConfig,
                     t: Callable) -> EncDec:
    """The port's encoder-decoder from a JAX ``init_encdec`` tree."""
    _only_keys(tree, _ENCDEC_KEYS, "encoder-decoder top-level")
    enc, dec = tree["enc_blocks"], tree["dec_blocks"]
    _only_keys(enc, _ENC_KEYS, "encoder block")
    _only_keys(dec, _DEC_KEYS, "decoder block")

    def attn(leaves):
        return _attention({k: t(v) for k, v in leaves.items()})

    enc_blocks = []
    for i in range(len(enc["ln1"]["w"])):
        lay = _layer(enc, i)
        enc_blocks.append(EncBlock(
            _layer_norm(lay["ln1"], t, "ln1"), attn(lay["attn"]),
            _layer_norm(lay["ln2"], t, "ln2"), _gelu_mlp(lay["mlp"], t)))
    dec_blocks = []
    for i in range(len(dec["ln1"]["w"])):
        lay = _layer(dec, i)
        dec_blocks.append(DecBlock(
            _layer_norm(lay["ln1"], t, "ln1"), attn(lay["self_attn"]),
            _layer_norm(lay["ln_x"], t, "ln_x"), attn(lay["cross_attn"]),
            _layer_norm(lay["ln2"], t, "ln2"), _gelu_mlp(lay["mlp"], t)))
    for what, blocks, want in (("encoder", enc_blocks,
                                cfg.n_enc_layers or cfg.n_layers),
                               ("decoder", dec_blocks, cfg.n_layers)):
        if len(blocks) != want:
            raise ValueError(f"{len(blocks)} {what} blocks in the tree, "
                             f"{want} in {cfg.name!r}")
    return EncDec(t(tree["enc_pos"]), enc_blocks,
                  _layer_norm(tree["enc_ln"], t, "enc_ln"), t(tree["embed"]),
                  t(tree["dec_pos"]), dec_blocks,
                  _layer_norm(tree["dec_ln"], t, "dec_ln"))


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig, *,
                    device: torch.device = "cuda") -> nn.Module:
    """The port's model holding the weights of a JAX ``init_lm`` pytree,
    or of an ``init_encdec`` one for an encoder-decoder config.  Raises
    ValueError on a key of the tree it does not map."""
    dev = resolve_device(device)

    def t(a: np.ndarray) -> torch.Tensor:
        return tensor_from_numpy(a, dev)

    if cfg.is_encoder_decoder:
        return _encdec_from_jax(tree, cfg, t)
    stacks = build_stacks(cfg)

    _only_keys(tree, _TOP_KEYS, "top-level")
    if len(tree["stacks"]) != len(stacks):
        raise ValueError(f"{len(tree['stacks'])} stacks in the tree, "
                         f"{len(stacks)} segments in {cfg.name!r}")
    blocks = []
    for (kind, n), stack in zip(stacks, tree["stacks"]):
        _only_keys(stack, _BLOCK_KEYS[kind], f"{kind} block")
        if kind == "ssm":
            _only_keys(stack["ssm"], _SSM_KEYS, "ssm")
        for i in range(n):
            lay = _layer(stack, i)
            if kind == "ssm":
                blocks.append(SSMBlock(t(lay["ln1"]), SSM(
                    **{k: t(v) for k, v in lay["ssm"].items()})))
                continue
            attn = _attention({k: t(v) for k, v in lay["attn"].items()})
            if kind == "moe":
                blocks.append(MoEBlock(t(lay["ln1"]), attn, t(lay["ln2"]),
                                       _moe(lay["moe"], t)))
            else:
                blocks.append(DenseBlock(t(lay["ln1"]), attn, t(lay["ln2"]),
                                         _swiglu({k: t(v) for k, v in
                                                  lay["mlp"].items()},
                                                 "mlp")))
    shared = tree.get("shared_attn")
    if shared is not None:
        _only_keys(shared, {"ln", "attn"}, "shared_attn")
        shared = SharedAttention(t(shared["ln"]), _attention(
            {k: t(v) for k, v in shared["attn"].items()}))
    proj = tree.get("projector")
    if proj is not None:
        _only_keys(proj, {"w1", "b1", "w2", "b2"}, "projector")
        proj = Projector(t(proj["w1"]), t(proj["b1"]), t(proj["w2"]),
                         t(proj["b2"]))
    head = tree.get("head")
    return LM(t(tree["embed"]), blocks, t(tree["final_norm"]),
              None if head is None else t(head), shared, proj)


# --------------------------------------------------------------------------
# the port's model -> the JAX tree
# --------------------------------------------------------------------------

def segment_starts(model: nn.Module) -> Tuple[int, ...]:
    """The first block of each segment of ``model``: where the class of
    its blocks changes (a MoE model's first MoE block after its dense
    ones); ``(0,)`` for one segment."""
    blocks = getattr(model, "blocks", None)
    if not isinstance(blocks, nn.ModuleList):
        return (0,)
    kinds = [type(b) for b in blocks]
    return (0, *(i for i in range(1, len(kinds)) if kinds[i] != kinds[i - 1]))


def jax_path(name: str, starts: Sequence[int] = (0,)
             ) -> Tuple[str, Optional[int]]:
    """The JAX tree path of a port parameter name and its layer index in
    its segment, the segments starting at blocks ``starts``
    (:func:`segment_starts`): ``blocks.3.attn.wq`` -> (``stacks/0/attn/wq``,
    3); with ``starts`` (0, 1), ``blocks.3.moe.router`` ->
    (``stacks/1/moe/router``, 2); ``shared_attn.ln`` -> (``shared_attn/ln``,
    None); ``projector.w1`` -> (``projector/w1``, None); the
    encoder-decoder's ``dec_blocks.2.ln_x.w`` ->
    (``dec_blocks/ln_x/w``, 2)."""
    parts = name.split(".")
    if parts[0] in _STACKED:
        return "/".join([parts[0], *parts[2:]]), int(parts[1])
    if parts[0] == "blocks":
        i = int(parts[1])
        s = max(k for k, first in enumerate(starts) if first <= i)
        return "/".join(["stacks", str(s), *parts[2:]]), i - starts[s]
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
    starts = segment_starts(model)
    for name, leaf in zip(named, leaves):
        path, layer = jax_path(name, starts)
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
                flat: Mapping[str, Any],
                cut: Optional[Callable[[str, torch.Tensor],
                                       torch.Tensor]] = None) -> None:
    """Copy ``flat`` ({JAX tree path: array or tensor, stacked on L}) into
    ``targets`` (aligned with ``model.parameters()``), in place and on the
    targets' devices, cast to their dtypes; ``cut(name, leaf)``, where
    given, first cuts each parameter's whole leaf to the target's piece (a
    rank's shard).  Raises ValueError on a path that no target takes or a
    target that no path fills, and on a shape that differs."""
    named = [n for n, _ in model.named_parameters()]
    if len(named) != len(targets):
        raise ValueError(f"{len(targets)} targets for {len(named)} "
                         "parameters")
    used = set()
    starts = segment_starts(model)
    with torch.no_grad():
        for name, t in zip(named, targets):
            path, layer = jax_path(name, starts)
            if path not in flat:
                raise ValueError(f"no leaf {path!r} for parameter {name!r}")
            used.add(path)
            src = flat[path]
            src = src if isinstance(src, torch.Tensor) else \
                torch.from_numpy(np.asarray(src))
            if layer is not None:
                src = src[layer]
            if cut is not None:
                src = cut(name, src)
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


def tree_from_params(model: nn.Module) -> Dict[str, Any]:
    """The JAX ``init_lm`` (or, for an :class:`EncDec`, ``init_encdec``)
    tree of the port's model, the inverse of :func:`params_from_jax`: numpy
    leaves, each block's leaf stacked on a leading L axis (``stacks[s]``
    for segment ``s``; ``enc_blocks``, ``dec_blocks``), bfloat16 bit for
    bit."""
    flat = flat_from_leaves(model, list(model.parameters()))
    return _nest({k: _numpy_from_tensor(v) for k, v in flat.items()})
