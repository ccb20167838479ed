"""Bridge between the JAX package's parameter pytrees and the port's.

The JAX package keeps parameters as nested dicts/lists of arrays; the port
keeps the same trees as tensors, except the encoders' conv kernels, which
take PyTorch's layouts: HuBERT's move from ``[K, C_in, C_out]`` to
``[C_out, C_in/groups, K]``, EfficientNet's from HWIO to OIHW. This module
is the one place that knows those layouts (:func:`encoder_conv_perms`,
dispatched on the encoder tree's kind). :func:`from_jax_params`
takes a full ASLM tree (``audio_encoder``, ``adapter``, ``lm_decoder``) as
numpy arrays (``jax.device_get`` of the JAX tree); :func:`to_jax_params` is
its inverse, as numpy. :func:`checkpoint_from_jax` does the same for a
whole training state (params, the optimizer's state, step) and writes it
as a port checkpoint. A JAX pipeline run's trees, whose encoder and LM
``layers`` are stacked (one ``[L, ...]`` leaf a name, the conv kernels
outside them), convert leaf for leaf into the port's stacked layout,
which a port pp trainer resumes as it is and any other trainer restores
across layouts (``AATTrainer.restore_checkpoint``).

It also reads Hugging Face checkpoints from a local directory into the
port's trees (the counterparts of the JAX package's ``port_hubert``,
``port_llama`` and ``port_pooling_encoder``; :func:`port_deepseek_v2` has
no JAX counterpart). The JAX readers go through a
live ``transformers`` module; these parse the files themselves
(``config.json``, ``model.safetensors`` or its sharded index, or
``pytorch_model.bin``), apply the ``transformers`` class defaults for the
keys a ``config.json`` leaves out, and give the trees that the JAX readers
give after :func:`from_jax_params`, in float32 whatever the stored dtype
(``from_pretrained`` without ``torch_dtype`` loads float32).
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch


def to_tensors(tree, device=None):
    """Numpy tree → the same tree of tensors on ``device`` (``None`` leaves
    stay ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_tensors(v, device) for v in tree]
    return torch.as_tensor(np.asarray(tree), device=device)


def _to_numpy(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_numpy(v) for v in tree]
    return tree.detach().cpu().numpy()


# the conv kernels whose layout differs, by the JAX-axis order of the port's
# axes: the port's axis i is the JAX layout's axis perm[i]
HUBERT_CONV_PERM = (2, 1, 0)  # JAX [K, C_in, C_out] → the port's [C_out, C_in, K]
EFFICIENTNET_CONV_PERM = (3, 2, 0, 1)  # JAX HWIO → the port's OIHW (not a reversal)


def _kernel_paths(tree, path=()):
    """Paths of every ``"kernel"`` leaf of a tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [path] if path and path[-1] == "kernel" else []
    return [p for k, v in items for p in _kernel_paths(v, path + (k,))]


def encoder_conv_perms(encoder: dict) -> dict:
    """``{path in the encoder tree: perm}`` of its conv kernels, by the
    tree's kind: HuBERT / wav2vec2 (the feature extractor's convs and the
    positional conv) or EfficientNet (every kernel: all are convs)."""
    if "feature_extractor" in encoder:
        paths = [("feature_extractor", i, "conv", "kernel")
                 for i in range(len(encoder["feature_extractor"]))] + [("pos_conv", "kernel")]
        return dict.fromkeys(paths, HUBERT_CONV_PERM)
    if "stem" in encoder:
        return dict.fromkeys(_kernel_paths(encoder), EFFICIENTNET_CONV_PERM)
    raise ValueError(f"unknown audio encoder tree (keys {sorted(encoder)})")


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _set(tree, path, value):
    _get(tree, path[:-1])[path[-1]] = value


def _carry(tree: dict, to_port: bool) -> dict:
    """The conv kernels of an encoder tree (``None`` leaves kept) permuted
    into the port's layout, or back to JAX's, in place."""
    for path, perm in encoder_conv_perms(tree).items():
        x = _get(tree, path)
        if x is None:
            continue
        if to_port:
            _set(tree, path, x.permute(perm).contiguous())
        else:
            _set(tree, path, np.ascontiguousarray(x.transpose(np.argsort(perm))))
    return tree


def encoder_from_jax(tree: dict, device=None) -> dict:
    """JAX audio-encoder parameters (numpy; HuBERT / wav2vec2 or
    EfficientNet) → the port's, conv kernels permuted."""
    return _carry(to_tensors(tree, device), True)


def from_jax_params(tree: dict, device=None) -> dict:
    """JAX ASLM parameters (numpy leaves; HuBERT / wav2vec2 or EfficientNet
    encoder) → the port's parameters."""
    return {
        "audio_encoder": encoder_from_jax(tree["audio_encoder"], device),
        "adapter": to_tensors(tree["adapter"], device),
        "lm_decoder": to_tensors(tree["lm_decoder"], device),
    }


def to_jax_params(params: dict) -> dict:
    """The port's ASLM parameters (or a moment tree of them, ``None`` on
    frozen leaves) → the JAX layout, as numpy."""
    out = _to_numpy(params)
    _carry(out["audio_encoder"], False)
    return out


def _unmask(tree):
    """JAX optimizer state → the port's: ``optax.MaskedNode`` (an empty
    tuple) or an empty dict, on frozen leaves, becomes ``None``."""
    if tree is None or (isinstance(tree, (tuple, list, dict)) and len(tree) == 0):
        return None
    if isinstance(tree, dict):
        return {k: _unmask(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_unmask(v) for v in tree]
    return tree


def _field(node, name):
    return node[name] if isinstance(node, dict) else getattr(node, name)


def _has_fields(node, names) -> bool:
    if isinstance(node, dict):
        return all(n in node for n in names)
    return isinstance(node, tuple) and all(n in getattr(node, "_fields", ()) for n in names)


def _find_state(tree, names):
    """The first node of a JAX optimizer state (NamedTuples, or the dicts
    and lists of a target-free orbax restore) that has the fields
    ``names``, depth first; None where there is none."""
    if _has_fields(tree, names):
        return tree
    children = (tree.values() if isinstance(tree, dict)
                else tree if isinstance(tree, (list, tuple)) else ())
    for child in children:
        found = _find_state(child, names)
        if found is not None:
            return found
    return None


def conv_perms(params: dict) -> dict:
    """``{path: perm}`` of an ASLM tree's conv kernels (paths from the
    root, as tuples of keys)."""
    return {("audio_encoder",) + path: perm
            for path, perm in encoder_conv_perms(params["audio_encoder"]).items()}


def adafactor_axes(params: dict) -> dict:
    """``{"audio_encoder/.../kernel": (d1, d0)}``: for each conv kernel, the
    axes (in the port's layout) that JAX's Adafactor factors its second
    moments over (``optim.factored_dims`` of the JAX shape). On the port's
    shape ``factored_dims`` can pick other axes where sizes tie (the
    EfficientNet stem, ``[3, 3, 3, 32]``); with these the port's Adafactor
    keeps JAX's statistics."""
    from aat_tpu_torch.training.optim import factored_dims

    out = {}
    for path, perm in conv_perms(params).items():
        shape = tuple(_get(params, path).shape)
        jax_shape = tuple(shape[perm.index(j)] for j in range(len(shape)))
        d1, d0 = factored_dims(jax_shape)
        out["/".join(map(str, path))] = (perm.index(d1), perm.index(d0))
    return out


def _factored_from_jax(v_row, v_col, params: dict):
    """Adafactor's factored moments of the JAX layout → the port's
    ``(v_row, v_col)`` trees (numpy; None on 1-D and frozen leaves). A
    statistic is a mean over one axis of the squared gradient, and the
    port's Adafactor reduces the same axes as JAX's
    (:func:`adafactor_axes`): each port statistic is the JAX one over the
    same axis, transposed to the port's axis order."""
    from aat_tpu_torch.training.optim import factored_dims

    perms = conv_perms(params)

    def walk(p, vr, vc, path):
        if isinstance(p, dict):
            parts = {k: walk(p[k], _sub(vr, k), _sub(vc, k), path + (k,)) for k in p}
            return ({k: v[0] for k, v in parts.items()}, {k: v[1] for k, v in parts.items()})
        if isinstance(p, (list, tuple)):
            parts = [walk(x, _sub(vr, i), _sub(vc, i), path + (i,)) for i, x in enumerate(p)]
            return [v[0] for v in parts], [v[1] for v in parts]
        shape = np.shape(p)
        if _unmask(vr) is None or len(shape) < 2:
            return None, None
        n = len(shape)
        perm = perms.get(path, tuple(range(n)))  # port axis -> JAX axis
        d1j, d0j = factored_dims(shape)
        by_axis = {d0j: np.asarray(vr), d1j: np.asarray(vc)}  # JAX stat by reduced axis

        def port_stat(axis_j):
            rest_j = [a for a in range(n) if a != axis_j]
            rest_p = [perm[i] for i in range(n) if perm[i] != axis_j]
            return np.ascontiguousarray(
                np.transpose(by_axis[axis_j], [rest_j.index(a) for a in rest_p]))

        return port_stat(d0j), port_stat(d1j)

    return walk(params, v_row, v_col, ())


def _sub(node, key):
    if node is None or (isinstance(node, (tuple, list, dict)) and len(node) == 0):
        return None
    return node[key]


def checkpoint_from_jax(state: dict, path: str, meta: Optional[dict] = None) -> str:
    """A JAX trainer's state as numpy trees, ``{"params", "opt_state",
    "step"}`` (what ``AATTrainer.save_checkpoint`` writes with orbax,
    restored and fetched), → a port checkpoint at ``path`` that
    ``AATTrainer.restore_checkpoint`` reads. ``opt_state`` is any of the
    JAX trainer's optimizer states, as its NamedTuples or as the dicts of
    a target-free restore, with ``MaskedNode`` on frozen leaves:

    - the fused guarded AdamW, ``(count, mu, nu, total_notfinite)``;
    - the unfused chain, ``adamw_grouped`` (its ``scale_by_adam`` count and
      moments), under ``guard_nonfinite`` or not;
    - ``adafactor`` (its ``scale_by_factored_rms`` count and moments),
      under ``guard_nonfinite`` or not.

    Moments take the params' layout change (:func:`from_jax_params`;
    Adafactor's factored moments :func:`_factored_from_jax`). ``meta``: the
    checkpoint's ``trainer_meta.json``, copied when given."""
    from aat_tpu_torch.training import checkpoint as ckpt_lib
    from aat_tpu_torch.training import optim

    opt, params = state["opt_state"], state["params"]
    ckpt_lib.write_params(path, int(np.asarray(state["step"])), from_jax_params(params))

    def count_of(node):
        return torch.as_tensor(np.asarray(_field(node, "count"), np.int32))

    adam_fields = ("count", "mu", "nu")
    if _has_fields(opt, adam_fields + ("total_notfinite",)):
        inner = None
        port_state = optim.FusedGuardedAdamWState(
            count_of(opt), from_jax_params(_unmask(_field(opt, "mu"))),
            from_jax_params(_unmask(_field(opt, "nu"))),
            torch.as_tensor(np.asarray(_field(opt, "total_notfinite"), np.float32)))
    elif (adam := _find_state(opt, adam_fields)) is not None:
        inner = optim.ScaleByAdamState(count_of(adam), from_jax_params(_unmask(_field(adam, "mu"))),
                                       from_jax_params(_unmask(_field(adam, "nu"))))
    else:
        fac = _find_state(opt, ("count", "v_row", "v_col", "v"))
        if fac is None:
            raise ValueError("unknown JAX optimizer state: no AdamW or Adafactor moments")
        v_row, v_col = _factored_from_jax(_field(fac, "v_row"), _field(fac, "v_col"), params)
        v = optim.tree_map(lambda p, x: x if x is not None and np.ndim(p) < 2 else None,
                           params, _masked_like(params, _field(fac, "v")))
        inner = optim.FactoredState(count_of(fac), to_tensors(v_row), to_tensors(v_col),
                                    to_tensors(v))
    if inner is not None:
        port_state = inner
        if _has_fields(opt, ("total_notfinite", "inner_state")):
            port_state = optim.GuardNonfiniteState(
                torch.as_tensor(np.asarray(_field(opt, "total_notfinite"), np.float32)), inner)
    ckpt_lib.write_optimizer(path, port_state)
    if meta is not None:
        ckpt_lib.write_json(path, ckpt_lib.META_FILE, meta)
    return path


def _masked_like(params, tree):
    """``tree`` with ``None`` where it is masked, in the structure of
    ``params`` (a masked subtree is None at its root)."""
    if isinstance(params, dict):
        return {k: _masked_like(v, _sub(tree, k)) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_masked_like(v, _sub(tree, i)) for i, v in enumerate(params)]
    return _unmask(tree)


def vq_state_from_jax(state, device=None):
    """A JAX ``VQState`` (numpy or JAX leaves) → the port's ``VQState``."""
    from aat_tpu_torch.ops.vq import VQState

    return VQState(*(torch.as_tensor(np.array(x), device=device) for x in state))


def vq_state_to_jax(state) -> tuple:
    """The port's ``VQState`` → ``(codebook, ema_counts, ema_sums)`` as
    numpy, the JAX ``VQState`` field order."""
    return tuple(x.detach().cpu().numpy() for x in state)


# ---------------------------------------------------------------------------
# Hugging Face checkpoints
# ---------------------------------------------------------------------------

# safetensors dtype → (numpy dtype of the stored bits, torch dtype to view
# them as, or None for numpy's own)
_SAFETENSORS_DTYPES = {"F32": (np.dtype("<f4"), None), "F16": (np.dtype("<f2"), None),
                       "BF16": (np.dtype("<i2"), torch.bfloat16)}

HfCheckpoint = Union[str, Tuple[dict, Dict[str, torch.Tensor]]]


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file: an 8-byte little-endian
    header length, a JSON header of ``{name: {dtype, shape, data_offsets}}``
    (``__metadata__`` skipped), then the data, offsets counted from the end
    of the header. Each tensor is a copy that owns its memory."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + header_len)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name} has dtype {info['dtype']}, which the "
                             "reader does not know")
        np_dtype, view = _SAFETENSORS_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        array = np.array(data[begin:end]).view(np_dtype).reshape(info["shape"])
        tensor = torch.from_numpy(array)
        out[name] = tensor.view(view) if view is not None else tensor
    del data
    return out


def _read_torch_bin(path: str) -> Dict[str, torch.Tensor]:
    state = torch.load(path, weights_only=True, map_location="cpu")
    return {k: v.clone() for k, v in state.items()}


def require_local_dir(path: str, what: str = "checkpoint") -> str:
    """``path`` if it is a local directory; a hub name raises
    ``FileNotFoundError`` (the port downloads nothing)."""
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{what} {path!r}: no such directory. Reading a pretrained {what} needs a local "
            "checkpoint directory (config.json with model.safetensors, its sharded index, "
            "or pytorch_model.bin); the port does not download from the hub")
    return path


def read_hf_checkpoint(path: str) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """``(config.json as a dict, {name: tensor})`` of a local HF checkpoint
    directory: ``model.safetensors``, a sharded ``model.safetensors.index.json``,
    ``pytorch_model.bin`` or a sharded ``pytorch_model.bin.index.json``, in
    that order of preference. Tensors keep their stored dtype."""
    require_local_dir(path)
    with open(os.path.join(path, "config.json")) as f:
        config = json.load(f)
    readers = (("model.safetensors", read_safetensors), ("pytorch_model.bin", _read_torch_bin))
    for name, read in readers:
        file = os.path.join(path, name)
        if os.path.exists(file):
            return config, read(file)
        index = file + ".index.json"
        if os.path.exists(index):
            with open(index) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            state: Dict[str, torch.Tensor] = {}
            for shard in shards:
                state.update(read(os.path.join(path, shard)))
            return config, state
    raise FileNotFoundError(f"{path}: no model.safetensors, pytorch_model.bin or sharded "
                            "index of either")


def _weights(checkpoint: HfCheckpoint, base: str, probe: str):
    """``(config dict, base model's weights, all weights)`` of a checkpoint
    directory or a ``(config, state)`` pair: the base model's are read under
    ``base + "."`` when the file's keys carry that prefix (a ``*ForCTC`` or
    ``*ForCausalLM`` file; ``probe`` is a key of the bare model)."""
    if isinstance(checkpoint, str):
        config, state = read_hf_checkpoint(checkpoint)
        where, copy = checkpoint, False
    else:
        (config, state), where, copy = checkpoint, base, True
    prefix = f"{base}." if f"{base}.{probe}" in state else ""
    return config, _Weights(state, prefix, where, copy), _Weights(state, "", where, copy)


# transformers' HubertConfig / Wav2Vec2Config defaults (the two agree on
# every key read here)
HF_HUBERT_DEFAULTS = {
    "conv_dim": (512, 512, 512, 512, 512, 512, 512),
    "conv_kernel": (10, 3, 3, 3, 3, 2, 2),
    "conv_stride": (5, 2, 2, 2, 2, 2, 2),
    "conv_bias": False,
    "feat_extract_norm": "group",
    "hidden_size": 768,
    "num_hidden_layers": 12,
    "num_attention_heads": 12,
    "intermediate_size": 3072,
    "layer_norm_eps": 1e-5,
    "do_stable_layer_norm": False,
    "num_conv_pos_embeddings": 128,
    "num_conv_pos_embedding_groups": 16,
    "feat_proj_dropout": 0.0,
    "hidden_dropout": 0.1,
    "attention_dropout": 0.1,
    "activation_dropout": 0.1,
    "layerdrop": 0.1,
}

# transformers' LlamaConfig defaults (num_key_value_heads: the attention
# head count)
HF_LLAMA_DEFAULTS = {
    "vocab_size": 32000,
    "hidden_size": 4096,
    "intermediate_size": 11008,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": None,
    "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0,
    "max_position_embeddings": 2048,
    "tie_word_embeddings": False,
    "attention_bias": False,
}


def _with_defaults(config: dict, defaults: dict) -> dict:
    out = dict(defaults)
    out.update({k: v for k, v in config.items() if k in defaults and v is not None})
    return out


def hubert_config_from_hf(config: dict):
    """HubertConfig of a HuBERT / wav2vec2 ``config.json`` dict (the JAX
    ``hubert_config_from_torch``); the dropout and LayerDrop rates act only
    in train mode."""
    from aat_tpu_torch.models.hubert import HubertConfig

    if config.get("conv_pos_batch_norm"):
        raise NotImplementedError("conv_pos_batch_norm=True (a batch-normed positional conv) "
                                  "is not supported")
    c = _with_defaults(config, HF_HUBERT_DEFAULTS)
    return HubertConfig(
        conv_dim=tuple(c["conv_dim"]), conv_kernel=tuple(c["conv_kernel"]),
        conv_stride=tuple(c["conv_stride"]), conv_bias=c["conv_bias"],
        feat_extract_norm=c["feat_extract_norm"], hidden_size=c["hidden_size"],
        num_hidden_layers=c["num_hidden_layers"], num_attention_heads=c["num_attention_heads"],
        intermediate_size=c["intermediate_size"], layer_norm_eps=c["layer_norm_eps"],
        do_stable_layer_norm=c["do_stable_layer_norm"],
        num_conv_pos_embeddings=c["num_conv_pos_embeddings"],
        num_conv_pos_embedding_groups=c["num_conv_pos_embedding_groups"],
        feature_projection_dropout=c["feat_proj_dropout"], hidden_dropout=c["hidden_dropout"],
        attention_dropout=c["attention_dropout"], activation_dropout=c["activation_dropout"],
        layerdrop=c["layerdrop"])


def llama_config_from_hf(config: dict):
    """LlamaConfig of a Llama-family ``config.json`` dict read as
    ``LlamaForCausalLM`` reads it (the JAX ``llama_config_from_torch``): a
    Qwen2 file has no ``attention_bias``, so the Llama default, False,
    holds, and its q/k/v biases are not read."""
    from aat_tpu_torch.models.llama import LlamaConfig

    c = _with_defaults(config, HF_LLAMA_DEFAULTS)
    if c["num_key_value_heads"] is None:
        c["num_key_value_heads"] = c["num_attention_heads"]
    head_dim = config.get("head_dim")
    if head_dim is not None and head_dim != c["hidden_size"] // c["num_attention_heads"]:
        raise NotImplementedError(f"head_dim {head_dim} other than hidden_size / "
                                  "num_attention_heads is not supported")
    return LlamaConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"], num_hidden_layers=c["num_hidden_layers"],
        num_attention_heads=c["num_attention_heads"],
        num_key_value_heads=c["num_key_value_heads"], rms_norm_eps=c["rms_norm_eps"],
        rope_theta=c["rope_theta"], max_position_embeddings=c["max_position_embeddings"],
        tie_word_embeddings=c["tie_word_embeddings"], attention_bias=c["attention_bias"])


class _Weights:
    """Named tensors of a state dict under a prefix, read as float32 tensors
    of their own (copies, unless ``read_hf_checkpoint`` already made them);
    a name the file lacks raises, naming it."""

    def __init__(self, state: Dict[str, torch.Tensor], prefix: str, where: str,
                 copy: bool = True):
        self.state, self.prefix, self.where, self.copy = state, prefix, where, copy

    def has(self, name: str) -> bool:
        return self.prefix + name in self.state

    def __call__(self, name: str) -> torch.Tensor:
        key = self.prefix + name
        if key not in self.state:
            raise KeyError(f"{self.where}: the checkpoint has no tensor {key}")
        return self.state[key].to(torch.float32, copy=self.copy)

    def dense(self, name: str, bias: bool = True) -> dict:
        """A torch Linear ``[out, in]`` → ``{"kernel": [in, out]}`` (and its bias)."""
        p = {"kernel": self(f"{name}.weight").t().contiguous()}
        if bias:
            p["bias"] = self(f"{name}.bias")
        return p

    def norm(self, name: str) -> dict:
        return {"scale": self(f"{name}.weight"), "bias": self(f"{name}.bias")}


def _weight_normed_conv(w: _Weights, name: str) -> torch.Tensor:
    """HuBERT's positional conv under ``weight_norm(dim=2)``: w = g · v / ‖v‖,
    the norm over dims 0 and 1 for each tap, folded in float64 and rounded
    once to float32 (``transformers`` folds in float32; the two agree to
    within f32 rounding of the norm). Stored as ``weight_g`` /
    ``weight_v``, as ``parametrizations.weight.original0`` / ``original1``
    (recent ``transformers``), or already folded as ``weight``."""
    if w.has(f"{name}.weight_g"):
        g, v = w(f"{name}.weight_g"), w(f"{name}.weight_v")
    elif w.has(f"{name}.parametrizations.weight.original0"):
        g = w(f"{name}.parametrizations.weight.original0")
        v = w(f"{name}.parametrizations.weight.original1")
    else:
        return w(f"{name}.weight").contiguous()
    # in float64: an f32 sum over the C_out * C_in/groups weights of a tap
    # (65,536 in hubert-large) is off by about 5e-6 relative
    v64 = v.double()
    return (v64 * (g.double() / torch.linalg.vector_norm(v64, dim=(0, 1), keepdim=True))).float()


def port_hubert(checkpoint: HfCheckpoint, encoder_type: str = "hubert"):
    """A HuBERT or wav2vec2 checkpoint (a local directory, or ``(config
    dict, state dict)``) → ``(params, HubertConfig)`` in the port's layout
    (conv kernels ``[C_out, C_in/groups, K]``, dense kernels ``[in, out]``).
    The ``hubert.`` / ``wav2vec2.`` prefix of a ``*ForCTC`` file is
    stripped and keys the model does not have (``lm_head.*``,
    ``masked_spec_embed``) are not read, as ``HubertModel.from_pretrained``
    does."""
    config_dict, w, _ = _weights(checkpoint, encoder_type, "feature_projection.projection.weight")
    config = hubert_config_from_hf(config_dict)

    params: dict = {"feature_extractor": []}
    for i in range(len(config.conv_dim)):
        base = f"feature_extractor.conv_layers.{i}"
        layer = {"conv": {"kernel": w(f"{base}.conv.weight").contiguous()}}
        if config.conv_bias:
            layer["conv"]["bias"] = w(f"{base}.conv.bias")
        if config.feat_extract_norm == "layer":
            layer["layer_norm"] = w.norm(f"{base}.layer_norm")
        elif i == 0:
            layer["group_norm"] = w.norm(f"{base}.layer_norm")
        params["feature_extractor"].append(layer)

    params["feature_projection"] = {"layer_norm": w.norm("feature_projection.layer_norm"),
                                    "projection": w.dense("feature_projection.projection")}
    params["pos_conv"] = {"kernel": _weight_normed_conv(w, "encoder.pos_conv_embed.conv"),
                          "bias": w("encoder.pos_conv_embed.conv.bias")}
    params["layers"] = []
    for i in range(config.num_hidden_layers):
        base = f"encoder.layers.{i}"
        params["layers"].append({
            "attention": {"q": w.dense(f"{base}.attention.q_proj"),
                          "k": w.dense(f"{base}.attention.k_proj"),
                          "v": w.dense(f"{base}.attention.v_proj"),
                          "out": w.dense(f"{base}.attention.out_proj")},
            "layer_norm": w.norm(f"{base}.layer_norm"),
            "feed_forward": {"intermediate": w.dense(f"{base}.feed_forward.intermediate_dense"),
                             "output": w.dense(f"{base}.feed_forward.output_dense")},
            "final_layer_norm": w.norm(f"{base}.final_layer_norm"),
        })
    params["encoder_layer_norm"] = w.norm("encoder.layer_norm")
    return params, config


def port_llama(checkpoint: HfCheckpoint):
    """A ``LlamaForCausalLM`` checkpoint (SmolLM; Qwen1.5 read through the
    Llama architecture, as the JAX package reads it) → ``(params,
    LlamaConfig)``. q/k/v biases are read only when the config says
    ``attention_bias``; ``lm_head`` only when the embeddings are untied."""
    config_dict, w, top = _weights(checkpoint, "model", "embed_tokens.weight")
    config = llama_config_from_hf(config_dict)
    bias = config.attention_bias
    params: dict = {"embed_tokens": {"embedding": w("embed_tokens.weight")},
                    "layers": [], "final_norm": {"scale": w("norm.weight")}}
    for i in range(config.num_hidden_layers):
        base = f"layers.{i}"
        params["layers"].append({
            "input_norm": {"scale": w(f"{base}.input_layernorm.weight")},
            "attention": {"q": w.dense(f"{base}.self_attn.q_proj", bias),
                          "k": w.dense(f"{base}.self_attn.k_proj", bias),
                          "v": w.dense(f"{base}.self_attn.v_proj", bias),
                          "out": w.dense(f"{base}.self_attn.o_proj", False)},
            "post_attention_norm": {"scale": w(f"{base}.post_attention_layernorm.weight")},
            "mlp": {"gate": w.dense(f"{base}.mlp.gate_proj", False),
                    "up": w.dense(f"{base}.mlp.up_proj", False),
                    "down": w.dense(f"{base}.mlp.down_proj", False)},
        })
    if not config.tie_word_embeddings:
        params["lm_head"] = top.dense("lm_head", False)
    return params, config


def deepseek_v2_config_from_hf(config: dict, experts_held: Optional[int] = None,
                               expert_offset: int = 0):
    """DeepseekV2Config of a DeepSeek-V2 ``config.json`` dict (the keys of
    the published file; ``rope_scaling`` of type yarn), holding routed
    experts ``[expert_offset, expert_offset + experts_held)`` (all of them
    when ``experts_held`` is None). Refuses what the port does not compute:
    a q LoRA, grouped top-k routing, sigmoid scores, a non-SiLU activation
    or k/v head counts other than the query heads'."""
    from aat_tpu_torch.models.deepseek_v2 import DeepseekV2Config

    refused = {"q_lora_rank": None, "topk_method": "greedy", "scoring_func": "softmax",
               "hidden_act": "silu"}
    for key, want in refused.items():
        if config.get(key, want) != want:
            raise NotImplementedError(f"DeepSeek-V2 with {key}={config[key]!r} is not supported")
    if config.get("num_key_value_heads", config["num_attention_heads"]) != \
            config["num_attention_heads"]:
        raise NotImplementedError("DeepSeek-V2 with num_key_value_heads other than "
                                  "num_attention_heads is not supported")
    rope = config.get("rope_scaling") or {}
    if rope and rope.get("type", rope.get("rope_type")) != "yarn":
        raise NotImplementedError(f"rope_scaling {rope!r} is not supported (yarn only)")
    n_routed = config["n_routed_experts"]
    held = n_routed if experts_held is None else experts_held
    if expert_offset < 0 or expert_offset + held > n_routed:
        raise ValueError(f"experts [{expert_offset}, {expert_offset + held}) do not lie among "
                         f"{n_routed}")
    keys = ("vocab_size", "hidden_size", "intermediate_size", "moe_intermediate_size",
            "num_hidden_layers", "num_attention_heads", "n_shared_experts", "n_routed_experts",
            "num_experts_per_tok", "routed_scaling_factor", "norm_topk_prob",
            "first_k_dense_replace", "moe_layer_freq", "kv_lora_rank", "qk_nope_head_dim",
            "qk_rope_head_dim", "v_head_dim", "rms_norm_eps", "rope_theta",
            "max_position_embeddings", "tie_word_embeddings")
    fields = {k: config[k] for k in keys if config.get(k) is not None}
    if rope:
        fields.update(rope_factor=float(rope["factor"]),
                      rope_original_max_position_embeddings=rope[
                          "original_max_position_embeddings"],
                      rope_beta_fast=float(rope.get("beta_fast", 32)),
                      rope_beta_slow=float(rope.get("beta_slow", 1)),
                      rope_mscale=float(rope.get("mscale", 1)),
                      rope_mscale_all_dim=float(rope.get("mscale_all_dim", 0)))
    else:
        fields.update(rope_factor=1.0, rope_mscale=1.0, rope_mscale_all_dim=0.0)
    return DeepseekV2Config(**fields, experts_held=held, expert_offset=expert_offset)


def port_deepseek_v2(checkpoint: HfCheckpoint, experts_held: Optional[int] = None,
                     expert_offset: int = 0):
    """A ``DeepseekV2ForCausalLM`` checkpoint (``q_proj``,
    ``kv_a_proj_with_mqa``, ``kv_a_layernorm``, ``kv_b_proj``, ``o_proj``;
    ``mlp.gate.weight``, ``mlp.experts.{e}.*``, ``mlp.shared_experts.*`` or a
    dense ``mlp``) → ``(params, DeepseekV2Config)``, with only the held
    routed experts read (:func:`deepseek_v2_config_from_hf`), stacked
    ``[held, in, out]``."""
    config_dict, w, top = _weights(checkpoint, "model", "embed_tokens.weight")
    config = deepseek_v2_config_from_hf(config_dict, experts_held, expert_offset)

    def mlp(base):
        return {"gate": w.dense(f"{base}.gate_proj", False),
                "up": w.dense(f"{base}.up_proj", False),
                "down": w.dense(f"{base}.down_proj", False)}

    params: dict = {"embed_tokens": {"embedding": w("embed_tokens.weight")},
                    "layers": [], "final_norm": {"scale": w("norm.weight")}}
    held = range(config.expert_offset, config.expert_offset + config.experts_held)
    for i in range(config.num_hidden_layers):
        base = f"layers.{i}"
        layer = {
            "input_norm": {"scale": w(f"{base}.input_layernorm.weight")},
            "attention": {"q": w.dense(f"{base}.self_attn.q_proj", False),
                          "kv_a": w.dense(f"{base}.self_attn.kv_a_proj_with_mqa", False),
                          "kv_norm": {"scale": w(f"{base}.self_attn.kv_a_layernorm.weight")},
                          "kv_b": w.dense(f"{base}.self_attn.kv_b_proj", False),
                          "out": w.dense(f"{base}.self_attn.o_proj", False)},
            "post_attention_norm": {"scale": w(f"{base}.post_attention_layernorm.weight")},
        }
        if config.is_moe_layer(i):
            experts = [mlp(f"{base}.mlp.experts.{e}") for e in held]
            layer["moe"] = {
                "router": {"weight": w(f"{base}.mlp.gate.weight")},
                "experts": {name: torch.stack([x[name]["kernel"] for x in experts])
                            for name in ("gate", "up", "down")},
                "shared": mlp(f"{base}.mlp.shared_experts")}
        else:
            layer["mlp"] = mlp(f"{base}.mlp")
        params["layers"].append(layer)
    if not config.tie_word_embeddings:
        params["lm_head"] = top.dense("lm_head", False)
    return params, config


def port_pooling_encoder(state: Dict[str, torch.Tensor], prefix: str = "") -> dict:
    """The reference's ``AudioEmbeddingsEncoderPooling`` weights (``l_in``,
    ``positional_embeddings``, a pre-LN ``nn.TransformerEncoder``,
    ``l_out``) from a state dict under ``prefix`` → the ``transformer_encoder``
    projection's tree (the JAX ``port_pooling_encoder``)."""
    w = _Weights(state, prefix, "pooling encoder")
    n_layers = len({k[len(prefix):].split(".")[2] for k in state
                    if k.startswith(prefix + "transformer_encoder.layers.")})
    params = {"l_in": w.dense("l_in"),
              "positional_embeddings": {"embedding": w("positional_embeddings.weight")},
              "l_out": w.dense("l_out"), "layers": []}
    for i in range(n_layers):
        base = f"transformer_encoder.layers.{i}"
        params["layers"].append({
            "attention": {"in_proj": {"kernel": w(f"{base}.self_attn.in_proj_weight").t()
                                      .contiguous(),
                                      "bias": w(f"{base}.self_attn.in_proj_bias")},
                          "out_proj": w.dense(f"{base}.self_attn.out_proj")},
            "norm1": w.norm(f"{base}.norm1"),
            "norm2": w.norm(f"{base}.norm2"),
            "linear1": w.dense(f"{base}.linear1"),
            "linear2": w.dense(f"{base}.linear2"),
        })
    return params
