"""The port's checkpoint files (the JAX package writes orbax, which needs
JAX; the port writes its own format in the same directory layout).

A checkpoint directory (``output_dir/checkpoint-{step}``, or an export of
``AATTrainer.save_pretrained``) holds:

- ``params.pt``: ``{"step": int, "params": {dotted path: tensor}}``, the
  path being the tree's keys and list indices joined by "." (for example
  ``audio_encoder.layers.0.attention.q.kernel``);
- ``optimizer.pt`` (checkpoints only): the optimizer state as one flat
  ``{dotted path: tensor}`` map, whatever the optimizer: the path takes the
  state's NamedTuple field names (``count``, ``mu.adapter.projection.in.
  kernel``, ``inner_state.v_row.…`` of a guarded Adafactor), and leaves
  without state (``None``: frozen leaves, Adafactor's unused slots) are
  omitted. Files of the fused AdamW's earlier nested form (``{"count",
  "total_notfinite", "mu": {path: tensor}, "nu": …}``) flatten to the same
  keys;
- ``trainer_meta.json`` (checkpoints) or ``config.json`` (exports).

Tensors are written from host copies and read with
``torch.load(weights_only=True, map_location=device)``, so every read
tensor is a fresh one: the fused AdamW updates parameters in place, and a
restored tree must share no storage with another trainer's.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

PARAMS_FILE = "params.pt"
OPTIMIZER_FILE = "optimizer.pt"
META_FILE = "trainer_meta.json"


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dicts, lists and NamedTuples (by field name) of tensors →
    ``{dotted path: tensor}``; ``None`` leaves (frozen optimizer state) are
    left out."""
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {} if tree is None else {prefix[:-1]: tree}
    out: Dict[str, torch.Tensor] = {}
    for key, sub in items:
        out.update(flatten(sub, f"{prefix}{key}."))
    return out


def unflatten_like(template, flat: Dict[str, torch.Tensor], prefix: str = ""):
    """The tree of ``template`` with each leaf read from ``flat`` by its
    path, cast to the template leaf's dtype (``None`` leaves stay ``None``).
    Raises ``KeyError`` on a missing path and ``ValueError`` on a shape
    that differs."""
    if isinstance(template, dict):
        return {k: unflatten_like(v, flat, f"{prefix}{k}.") for k, v in template.items()}
    if hasattr(template, "_fields"):
        return type(template)(*(unflatten_like(v, flat, f"{prefix}{k}.")
                                for k, v in zip(template._fields, template)))
    if isinstance(template, (list, tuple)):
        return [unflatten_like(v, flat, f"{prefix}{i}.") for i, v in enumerate(template)]
    if template is None:
        return None
    path = prefix[:-1]
    x = flat[path]
    if x.shape != template.shape:
        raise ValueError(f"{path}: saved shape {tuple(x.shape)}, expected {tuple(template.shape)}")
    return x.to(template.dtype)


def _host(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    # a copy of each tensor's own elements, whatever storage it views
    return {k: v.detach().to("cpu", copy=True) for k, v in flat.items()}


def write_params(path: str, step: int, params) -> None:
    os.makedirs(path, exist_ok=True)
    torch.save({"step": int(step), "params": _host(flatten(params))},
               os.path.join(path, PARAMS_FILE))


def write_optimizer(path: str, opt_state) -> None:
    """Any optimizer state of :mod:`~aat_tpu_torch.training.optim`, as its
    flat dotted-path map."""
    os.makedirs(path, exist_ok=True)
    torch.save(_host(flatten(opt_state)), os.path.join(path, OPTIMIZER_FILE))


def write_json(path: str, name: str, obj: Dict[str, Any]) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, name), "w") as f:
        json.dump(obj, f, indent=2)


def read_params(path: str, device) -> Dict[str, Any]:
    """``{"step", "params": {path: tensor}}`` of ``path``'s ``params.pt``."""
    return torch.load(os.path.join(path, PARAMS_FILE), weights_only=True, map_location=device)


def read_optimizer(path: str, device) -> Optional[Dict[str, torch.Tensor]]:
    """``optimizer.pt`` of ``path`` as its flat dotted-path map, or None
    where there is none."""
    file = os.path.join(path, OPTIMIZER_FILE)
    if not os.path.exists(file):
        return None
    return flatten(torch.load(file, weights_only=True, map_location=device))


def read_checkpoint_meta(path: str) -> Dict[str, Any]:
    """A checkpoint's trainer_meta.json (step, freeze flags, metric), or {}
    where there is none."""
    meta_path = os.path.join(os.path.abspath(path), META_FILE)
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)
