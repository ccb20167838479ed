"""Bridge between the JAX package's parameter pytrees and the port's.

The JAX package keeps parameters as nested dicts/lists of arrays; the port
keeps the same trees as tensors, except HuBERT conv kernels, which move
from ``[K, C_in, C_out]`` to PyTorch's ``[C_out, C_in/groups, K]``. This
module is the one place that knows that layout. :func:`from_jax_params`
takes a full ASLM tree (``audio_encoder``, ``adapter``, ``lm_decoder``) as
numpy arrays (``jax.device_get`` of the JAX tree); :func:`to_jax_params` is
its inverse, as numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def to_tensors(tree, device=None):
    """Numpy tree → the same tree of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_tensors(v, device) for v in tree]
    return torch.as_tensor(np.asarray(tree), device=device)


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


def _conv_kernels(hubert_tree: dict):
    """The HuBERT tree's conv-kernel holders (feature extractor + pos conv)."""
    return [layer["conv"] for layer in hubert_tree["feature_extractor"]] + [hubert_tree["pos_conv"]]


def hubert_from_jax(tree: dict, device=None) -> dict:
    """JAX HuBERT parameters (numpy) → the port's, conv kernels permuted."""
    out = to_tensors(tree, device)
    for holder in _conv_kernels(out):
        holder["kernel"] = holder["kernel"].permute(2, 1, 0).contiguous()
    return out


def from_jax_params(tree: dict, device=None) -> dict:
    """JAX ASLM parameters (numpy leaves) → the port's parameters."""
    return {
        "audio_encoder": hubert_from_jax(tree["audio_encoder"], device),
        "adapter": to_tensors(tree["adapter"], device),
        "lm_decoder": to_tensors(tree["lm_decoder"], device),
    }


def to_jax_params(params: dict) -> dict:
    """The port's ASLM parameters → the JAX layout, as numpy."""
    out = _to_numpy(params)
    for holder in _conv_kernels(out["audio_encoder"]):
        holder["kernel"] = np.ascontiguousarray(holder["kernel"].transpose(2, 1, 0))
    return out
