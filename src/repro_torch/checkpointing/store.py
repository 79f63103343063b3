"""Checkpoints in the JAX package's layout (``repro/checkpointing/store.py``),
so that either package restores what the other saved.

Each checkpoint is a directory ``step_XXXXXXXX`` holding ``params.npz``,
``opt_state.npz`` and ``meta.json`` (``{"step": ..., **extra}``).  A ``.npz``
maps the JAX tree path of each leaf, its keys joined by ``/``
(``stacks/0/attn/wq``, ``master/embed``, ``step``), to the leaf as a numpy
array; every layer's leaf is stacked on a leading L axis, as the JAX
``init_lm`` tree has it, and a bfloat16 leaf is stored as float32 under
``<path>@bf16``.  ``opt_state.npz`` holds ``step`` (an int32 scalar) and
``master``, ``m`` and ``v``, each laid out like the params.

The port's params are an ``LM`` module of per-block modules and its AdamW
state holds lists in ``params.parameters()`` order
(``repro_torch/optim/adamw.py``); ``bridge.py`` maps both to and from the
JAX paths.  Restoring writes into the template's tensors, in place and on
their devices, and raises on a stored leaf that the template does not take,
rather than leave a weight behind.
"""
from __future__ import annotations

import json
import pathlib
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import assign_flat, flat_from_leaves
from repro_torch.models.transformer import LM

_BF16 = "@bf16"


def _walk(tree: Any, prefix: Tuple[str, ...] = ()):
    """(path, leaf) of a nested tree of dicts and lists, in the JAX
    flattening order (dict keys sorted, list items in order)."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _array(leaf: Any) -> Tuple[np.ndarray, bool]:
    """A leaf as numpy and whether it is bfloat16 (stored as float32)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.float().numpy(), True
        return t.numpy(), False
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.astype(np.float32), True
    return arr, False


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    flat = {}
    for path, leaf in _walk(tree):
        arr, bf16 = _array(leaf)
        flat[path + _BF16 if bf16 else path] = arr
    return flat


def save_pytree(tree: Any, path: str | pathlib.Path) -> None:
    """Write a nested tree of dicts and lists of tensors or arrays to one
    ``.npz`` in the JAX package's layout."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **_flatten(tree))


def _read(path: str | pathlib.Path) -> Dict[str, np.ndarray]:
    """{tree path: array} of a ``.npz``, bfloat16 leaves as float32 under
    their path without the ``@bf16`` suffix."""
    with np.load(pathlib.Path(path), allow_pickle=False) as data:
        return {(k[:-len(_BF16)] if k.endswith(_BF16) else k): data[k]
                for k in data.files}


def load_pytree(template: Any, path: str | pathlib.Path) -> Any:
    """Restore into the structure of ``template`` (same tree paths): a
    tensor leaf is overwritten in place and returned, any other leaf comes
    back as a numpy array of the template leaf's dtype and shape.  Raises
    KeyError for a path the file lacks, ValueError for a stored path the
    template does not have."""
    lookup = _read(path)
    leaves = dict(_walk(template))
    extra = set(lookup) - set(leaves)
    if extra:
        raise ValueError(f"{path}: leaves {sorted(extra)} are not in the "
                         "template")

    def restore(tree, prefix=()):
        if isinstance(tree, Mapping):
            return {k: restore(v, prefix + (str(k),))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(restore(v, prefix + (str(i),))
                              for i, v in enumerate(tree))
        arr = lookup["/".join(prefix)]
        if isinstance(tree, torch.Tensor):
            with torch.no_grad():
                tree.copy_(torch.from_numpy(arr).reshape(tree.shape))
            return tree
        t = np.asarray(tree)
        return arr.astype(t.dtype).reshape(t.shape)

    return restore(template)


def _opt_tree(params: LM, opt_state: Mapping[str, Any]) -> Dict[str, Any]:
    return {"step": np.asarray(opt_state["step"], np.int32),
            **{k: flat_from_leaves(params, opt_state[k])
               for k in ("master", "m", "v")}}


def save_train_state(step: int, params: LM, opt_state: Mapping[str, Any],
                     directory: str | pathlib.Path,
                     extra: Optional[Dict[str, Any]] = None) -> pathlib.Path:
    """Write ``directory/step_XXXXXXXX/{params.npz, opt_state.npz,
    meta.json}`` for the port's model and AdamW state; returns the step's
    directory."""
    d = pathlib.Path(directory) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    save_pytree(flat_from_leaves(params, list(params.parameters())),
                d / "params.npz")
    save_pytree(_opt_tree(params, opt_state), d / "opt_state.npz")
    (d / "meta.json").write_text(json.dumps({"step": step, **(extra or {})}))
    return d


def restore_train_state(params_template: LM,
                        opt_template: Dict[str, Any],
                        directory: str | pathlib.Path,
                        step: Optional[int] = None
                        ) -> Tuple[LM, Dict[str, Any], int]:
    """Restore the newest checkpoint under ``directory`` (or ``step``'s)
    into ``params_template`` and ``opt_template`` in place; returns them
    and the step.  Raises FileNotFoundError when there is none, and
    ValueError when a stored leaf is not the template's."""
    d = pathlib.Path(directory)
    if step is None:
        cands = sorted(d.glob("step_*"))
        if not cands:
            raise FileNotFoundError(f"no checkpoints under {d}")
        d = cands[-1]
    else:
        d = d / f"step_{step:08d}"
    meta = json.loads((d / "meta.json").read_text())
    leaves = list(params_template.parameters())
    assign_flat(params_template, leaves, _read(d / "params.npz"))
    opt = _read(d / "opt_state.npz")
    groups: Dict[str, Dict[str, np.ndarray]] = {"master": {}, "m": {},
                                                "v": {}}
    for path, arr in opt.items():
        head, _, rest = path.partition("/")
        if path == "step":
            continue
        if head not in groups or not rest:
            raise ValueError(f"{d / 'opt_state.npz'}: leaf {path!r} is not "
                             "step, master, m or v")
        groups[head][rest] = arr
    for k, flat in groups.items():
        assign_flat(params_template, opt_template[k], flat)
    opt_template["step"] = int(opt["step"])
    return params_template, opt_template, int(meta["step"])
