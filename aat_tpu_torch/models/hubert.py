"""HuBERT / wav2vec2 speech encoder (counterpart of
``aat_tpu/models/hubert.py``), eval and train mode.

conv feature extractor (strided 1-D convs, 'layer' or 'group' norm) →
feature projection → grouped positional conv (SamePad) → transformer
encoder (post-LN 'base' or pre-LN 'stable layer norm' large). Parameters
are plain dictionaries of tensors with the JAX package's tree layout,
except that conv kernels are stored in PyTorch's ``[C_out, C_in/groups,
K]`` order (see :mod:`aat_tpu_torch.utils.port`).

Train mode (a ``dropout_seed``) applies the torch train-mode
regularization of the JAX package: feature-projection dropout, hidden
dropout after the positional conv, per-layer attention-probability,
residual and activation dropout, and LayerDrop. The JAX package derives
each site's key from one PRNG key with ``split``/``fold_in``; the port
derives each site's int32 seed from one int32 seed with
:func:`~aat_tpu_torch.ops.dropout.fold_seed`, on the host. The two cannot
draw the same bits, so masks agree in distribution, not element for
element (op-level parity is held with explicit seeds). A dropped layer is
skipped, where JAX computes it and selects the input: the result is the
same, and its parameters get no gradient (``None``), which the optimizer
reads as zero.

Remat (``HubertConfig.remat``) trades FLOPs for memory per encoder layer
under autograd, as the JAX ``jax.checkpoint`` does: ``"full"`` keeps only
each layer's input and recomputes the layer in the backward
(``torch.utils.checkpoint``, non-reentrant); ``"dots"`` keeps the outputs
of the products without batch dimensions (``aten.mm`` / ``addmm``: the
projections and the feed-forward), as JAX's
``dots_with_no_batch_dims_saveable`` does, and recomputes the rest: the
plain attention's batched ``bmm`` products and the flash kernel (its
ctypes launch is no aten op, as the Pallas call is no dot for JAX).
Dropout masks come from seeds, so the recompute redraws them exactly, and
LayerDrop is decided outside the checkpointed layer. Without autograd
(evaluation, serving) a layer runs once.

Multi-device (``mesh``, the trainer's :class:`~aat_tpu_torch.parallel.
mesh.Mesh`, which ``AslmModel`` passes in): under tensor parallelism, where
:func:`tp_partitionable` holds, each layer is a Megatron body on this
rank's heads and feed-forward columns (the parameters arrive as shards),
the out and output products partial, all-reduced, then their bias. The
attention dropout keys this rank's heads on their global index
(:func:`tp_head_keys`, the kernels' ``head_keys``) and the activation
dropout its columns on their global place (``ElementShard.cols``), so tp
draws one device's masks, as JAX's tp without pp does on its global
arrays. (JAX's pipeline bodies salt both seeds by the tp index instead.)
Under sequence parallelism the feature extractor and the
positional conv run whole on every sp rank, the layer stack runs on this
rank's time slice with Ulysses attention
(:mod:`aat_tpu_torch.parallel.sequence`), and its output is gathered over
time before the last layer norm. Every dropout mask is keyed on the
element's global position (:class:`~aat_tpu_torch.ops.dropout.
ElementShard`), so data parallelism draws one device's masks.

Under pipeline parallelism (the mesh's pp axis; JAX's
``_encoder_pipelined``) the layers arrive stacked, this stage's slice, and
run in :func:`~aat_tpu_torch.parallel.pipeline.gpipe_apply`'s schedule:
tensor-parallel bodies inside the stage where :func:`tp_partitionable`
holds, remat inside it, LayerDrop decided once a layer a step for the
whole batch on the *global* layer index (a skipped layer is skipped, as in
the one-device loop), and each microbatch's masks keyed as its first
global row, so they equal one device's. (JAX folds the microbatch index
into its keys instead, so its pp masks differ from its own one-device
run's.) Pipeline and sequence parallelism do not nest.

Left out (TPU layout devices): the chunked and im2col/space-to-depth conv
forms, and the pre-pad to the flash block multiple (with dropout on, the
pre-pad changes the flat positions the JAX masks are keyed on).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint as torch_checkpoint

from aat_tpu_torch.ops.attention import attention_bthd
from aat_tpu_torch.ops.dropout import (
    ElementShard,
    dropout,
    fold_seed,
    shift_head_seed,
    uniform_from_seed,
)
from aat_tpu_torch.ops.layer_norm import layer_norm
from aat_tpu_torch.parallel import comm, sequence
from aat_tpu_torch.parallel.pipeline import gpipe_apply, layer_seq
from aat_tpu_torch.utils.port import encoder_from_jax


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    conv_dim: Tuple[int, ...] = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = True
    feat_extract_norm: str = "layer"  # 'layer' (large) | 'group' (base)
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    intermediate_size: int = 4096
    layer_norm_eps: float = 1e-5
    do_stable_layer_norm: bool = True
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    feature_projection_dropout: float = 0.0
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    activation_dropout: float = 0.0
    layerdrop: float = 0.0  # torch train-mode LayerDrop (whole-layer skip)
    attention_impl: str = "xla"  # 'xla' (plain) | 'pallas' (flash kernel)
    remat: bool = False  # recompute encoder layers in the backward (memory for FLOPs)
    remat_policy: str = "full"  # 'full' | 'dots' (matrix-product outputs kept)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def tp_partitionable(config: HubertConfig, tp: int) -> bool:
    """True when the layers' heads and feed-forward hidden split evenly
    over ``tp`` (the gate of the tensor-parallel body, JAX's predicate)."""
    return (tp > 1 and config.num_attention_heads % tp == 0
            and config.intermediate_size % tp == 0)


def _tp_group(config: HubertConfig, mesh):
    """The tp group when the layers run as tensor-parallel bodies, else None."""
    if mesh is None or not tp_partitionable(config, mesh.size("tp")):
        return None
    return mesh.group("tp")


def hubert_large_config() -> HubertConfig:
    """facebook/hubert-large-ls960-ft, with the flash kernel requested and
    the HF train-mode dropout rates of the JAX config (they act only when a
    ``dropout_seed`` is passed)."""
    return HubertConfig(attention_impl="pallas", hidden_dropout=0.1,
                        attention_dropout=0.1, activation_dropout=0.1, layerdrop=0.1)


def wav2vec2_large_config() -> HubertConfig:
    """facebook/wav2vec2-large-lv60: the same inference graph as hubert-large."""
    return HubertConfig(attention_impl="pallas")


def tiny_test_config() -> HubertConfig:
    """Small random config for parity tests."""
    return HubertConfig(
        conv_dim=(16, 16, 16), conv_kernel=(10, 3, 3), conv_stride=(5, 2, 2),
        hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, num_conv_pos_embeddings=16,
        num_conv_pos_embedding_groups=4,
    )


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def np_rng_from(seed) -> np.random.Generator:
    """The host generator the JAX package's ``np_rng_from`` makes: an int
    seeds ``default_rng`` directly; a JAX PRNG key enters as its data words
    (``jax.random.key_data``: ``(0, 0)`` for ``PRNGKey(0)``, ``(0, 1)`` for
    ``PRNGKey(1)``), which seed a ``SeedSequence``."""
    if isinstance(seed, (int, np.integer)):
        return np.random.default_rng(int(seed))
    return np.random.default_rng(np.random.SeedSequence([int(x) for x in seed]))


def init_hubert_numpy(seed, config: HubertConfig) -> dict:
    """The JAX package's draws (normal std 0.02 from :func:`np_rng_from`),
    in its layout: conv kernels ``[K, C_in, C_out]``."""
    r = np_rng_from(seed)
    std = 0.02

    def normal(*shape):
        return r.normal(0.0, std, shape).astype(np.float32)

    def dense(din, dout):
        return {"kernel": normal(din, dout), "bias": np.zeros((dout,), np.float32)}

    def layernorm(d):
        return {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)}

    params: dict = {"feature_extractor": []}
    in_ch = 1
    for i, (dim, kernel) in enumerate(zip(config.conv_dim, config.conv_kernel)):
        layer = {"conv": {"kernel": normal(kernel, in_ch, dim)}}
        if config.conv_bias:
            layer["conv"]["bias"] = np.zeros((dim,), np.float32)
        if config.feat_extract_norm == "layer":
            layer["layer_norm"] = layernorm(dim)
        elif i == 0:
            layer["group_norm"] = layernorm(dim)
        params["feature_extractor"].append(layer)
        in_ch = dim

    h = config.hidden_size
    params["feature_projection"] = {
        "layer_norm": layernorm(config.conv_dim[-1]),
        "projection": dense(config.conv_dim[-1], h),
    }
    params["pos_conv"] = {
        "kernel": normal(config.num_conv_pos_embeddings,
                         h // config.num_conv_pos_embedding_groups, h),
        "bias": np.zeros((h,), np.float32),
    }
    params["layers"] = []
    for _ in range(config.num_hidden_layers):
        params["layers"].append({
            "attention": {"q": dense(h, h), "k": dense(h, h), "v": dense(h, h),
                          "out": dense(h, h)},
            "layer_norm": layernorm(h),
            "feed_forward": {"intermediate": dense(h, config.intermediate_size),
                             "output": dense(config.intermediate_size, h)},
            "final_layer_norm": layernorm(h),
        })
    params["encoder_layer_norm"] = layernorm(h)
    return params


def init_hubert_params(seed, config: HubertConfig, device=None) -> dict:
    """Random init equal to the JAX package's ``init_hubert_params`` of the
    same int seed or PRNG key."""
    return encoder_from_jax(init_hubert_numpy(seed, config), device)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer_norm(x, p, eps):
    return layer_norm(x, p["scale"], p["bias"], eps)


def _dense(x, p):
    return torch.matmul(x, p["kernel"].to(x.dtype)) + p["bias"]


def _conv_stack(params, config: HubertConfig, x: torch.Tensor) -> torch.Tensor:
    """[B, L] → [B, T, conv_dim[-1]] through plain ``conv1d`` (channels-first
    inside, the JAX [B, T, C] layout at the boundary)."""
    h = x[:, None, :]  # [B, 1, L]
    for i, layer in enumerate(params["feature_extractor"]):
        h = F.conv1d(h, layer["conv"]["kernel"].to(h.dtype), layer["conv"].get("bias"),
                     stride=config.conv_stride[i])
        if "layer_norm" in layer:  # over C: the transposes are views (ops/layer_norm)
            h = _layer_norm(h.transpose(1, 2), layer["layer_norm"],
                            config.layer_norm_eps).transpose(1, 2)
        if "group_norm" in layer:
            # GroupNorm(num_groups=dim): per-channel over the length axis
            mean = h.mean(-1, keepdim=True)
            var = ((h - mean) ** 2).mean(-1, keepdim=True)
            h = (h - mean) * torch.rsqrt(var + config.layer_norm_eps)
            h = h * layer["group_norm"]["scale"][:, None] + layer["group_norm"]["bias"][:, None]
        h = F.gelu(h)
    return h.transpose(1, 2)


def feature_lengths(config: HubertConfig, input_lengths: torch.Tensor) -> torch.Tensor:
    """Conv output lengths (torch ``_get_feat_extract_output_lengths``)."""
    lengths = input_lengths
    for kernel, stride in zip(config.conv_kernel, config.conv_stride):
        lengths = torch.div(lengths - kernel, stride, rounding_mode="floor") + 1
    return lengths


def feature_vector_attention_mask(config: HubertConfig, feature_seq_len: int,
                                  attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, L] sample mask → [B, T] bool frame mask."""
    out_lens = feature_lengths(config, attention_mask.sum(-1))
    return torch.arange(feature_seq_len, device=attention_mask.device)[None, :] < out_lens[:, None]


def _pos_conv_embedding(params, config: HubertConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Grouped relative-positional conv + GELU (wav2vec2 SamePad)."""
    k = config.num_conv_pos_embeddings
    pad = k // 2
    x = F.conv1d(hidden.transpose(1, 2), params["pos_conv"]["kernel"].to(hidden.dtype),
                 params["pos_conv"]["bias"], padding=pad,
                 groups=config.num_conv_pos_embedding_groups)
    if k % 2 == 0:  # SamePad: drop the trailing element for even kernels
        x = x[:, :, :-1]
    return F.gelu(x).transpose(1, 2)


def tp_head_keys(nh: int, mesh) -> Tuple[int, int]:
    """The attention dropout's ``(heads_total, head_offset)`` on this tp
    rank's ``nh`` heads: their place among the layer's heads, so the rank
    draws one device's masks."""
    return nh * mesh.size("tp"), mesh.index("tp") * nh


def _attention(params, config: HubertConfig, x, frame_mask, dropout_seed=None, shard=None,
               mesh=None):
    """Self-attention; under tp on this rank's heads (the q/k/v/out
    parameters are its shards), under sp on its time slice (Ulysses)."""
    b, t, _ = x.shape
    hd = config.head_dim
    tp_group = _tp_group(config, mesh)
    x = comm.copy_to_group(x, tp_group)
    nh = params["q"]["kernel"].shape[-1] // hd
    q = _dense(x, params["q"]).reshape(b, t, nh, hd)
    k = _dense(x, params["k"]).reshape(b, t, nh, hd)
    v = _dense(x, params["v"]).reshape(b, t, nh, hd)
    key_mask = (frame_mask.to(torch.int32) if frame_mask is not None
                else torch.ones((b, t), dtype=torch.int32, device=x.device))
    seed, head_keys = dropout_seed, None
    if seed is not None and config.attention_dropout > 0.0:
        if tp_group is not None:
            head_keys = tp_head_keys(nh, mesh)
        if shard is not None:
            seed = shift_head_seed(seed, shard.row_block * b, head_keys[0] if head_keys else nh)
    kw = dict(sm_scale=hd ** -0.5, use_kernel=config.attention_impl == "pallas",
              dropout_rate=config.attention_dropout, dropout_seed=seed, head_keys=head_keys)
    if mesh is not None and mesh.size("sp") > 1:
        ctx = sequence.ulysses_attention_bthd(q, k, v, key_mask, mesh, **kw)
    else:
        ctx = attention_bthd(q, k, v, key_mask, causal=False, **kw)
    return _dense_row_parallel(ctx.reshape(b, t, nh * hd), params["out"], tp_group)


def _dense_row_parallel(x, p, tp_group):
    """``_dense`` whose kernel's input rows may be this rank's tp shard:
    the partial products all-reduced over ``tp_group``, then the bias once."""
    y = comm.reduce_from_group(torch.matmul(x, p["kernel"].to(x.dtype)), tp_group)
    return y + p["bias"]


def _feed_forward(params, x, config: HubertConfig, dropout_seed=None, shard=None, mesh=None):
    tp_group = _tp_group(config, mesh)
    y = F.gelu(_dense(comm.copy_to_group(x, tp_group), params["intermediate"]))
    if dropout_seed is None:
        return _dense_row_parallel(y, params["output"], tp_group)
    # HF HubertFeedForward: intermediate_dropout (activation_dropout), then
    # output_dropout (hidden_dropout). Under tp the activation is this
    # rank's columns, keyed on their global place; the output is replicated
    # and keeps one mask.
    act_shard = shard
    if tp_group is not None:
        width = y.shape[-1]
        act_shard = (shard or ElementShard())._replace(
            cols=(mesh.index("tp") * width, width * mesh.size("tp")))
    y = dropout(fold_seed(dropout_seed, 0), y, config.activation_dropout, act_shard)
    return dropout(fold_seed(dropout_seed, 1), _dense_row_parallel(y, params["output"], tp_group),
                   config.hidden_dropout, shard)


_HIDDEN_SITE = 1 << 16  # encoder seed site of the post-positional-conv dropout
_LAYERDROP_SITE = 1 << 20  # layer seed site of the LayerDrop draw


def _layer(layer, config: HubertConfig, hidden, frame_mask, seed, shard=None, mesh=None):
    """One encoder layer; ``seed`` (or None) is the layer's dropout seed,
    split into attention (0), attention-residual (1) and feed-forward (2);
    ``shard`` places ``hidden`` in the global batch for the masks."""
    eps = config.layer_norm_eps
    s_attn = s_res = s_ff = None
    if seed is not None:
        s_attn, s_res, s_ff = (fold_seed(seed, i) for i in range(3))
    if config.do_stable_layer_norm:  # pre-LN (large)
        attn_in = _layer_norm(hidden, layer["layer_norm"], eps)
        attn_out = _attention(layer["attention"], config, attn_in, frame_mask, s_attn, shard,
                              mesh)
        hidden = hidden + dropout(s_res, attn_out, config.hidden_dropout, shard)
        ff_in = _layer_norm(hidden, layer["final_layer_norm"], eps)
        return hidden + _feed_forward(layer["feed_forward"], ff_in, config, s_ff, shard, mesh)
    attn_out = _attention(layer["attention"], config, hidden, frame_mask, s_attn, shard,
                          mesh)  # post-LN
    hidden = _layer_norm(hidden + dropout(s_res, attn_out, config.hidden_dropout, shard),
                         layer["layer_norm"], eps)
    hidden = hidden + _feed_forward(layer["feed_forward"], hidden, config, s_ff, shard, mesh)
    return _layer_norm(hidden, layer["final_layer_norm"], eps)


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """The ``"dots"`` remat policy (JAX's ``dots_with_no_batch_dims_saveable``):
    keep the outputs of products without batch dimensions (a ``[B, T, D]``
    activation by a ``[D, K]`` weight dispatches ``aten.mm``); attention's
    batched ``bmm`` products (QKᵀ, P·V) are recomputed."""
    if op in _SAVED_BY_DOTS:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def run_remat(fn, config, *args):
    """``fn(*args)``, one layer, checkpointed when ``config.remat`` and
    autograd is recording: ``"full"`` keeps only its inputs, ``"dots"``
    (``config.remat_policy``) the outputs of :func:`_dots_policy`'s
    products too. The layers draw no torch RNG (dropout hashes its seed),
    so the RNG state need not be saved for the recompute."""
    if not (config.remat and torch.is_grad_enabled()):
        return fn(*args)
    kw = {}
    if config.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, _dots_policy)
    return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                                       **kw)


def _run_layer(layer, config: HubertConfig, hidden, frame_mask, seed, shard=None, mesh=None):
    """One encoder layer, checkpointed when ``config.remat``."""
    return run_remat(_layer, config, layer, config, hidden, frame_mask, seed, shard, mesh)


def _dropped(config: HubertConfig, seed: Optional[int]) -> bool:
    """Whether LayerDrop skips the layer of ``seed`` (one draw a layer a
    step, for the whole batch)."""
    return (seed is not None and config.layerdrop > 0.0
            and uniform_from_seed(fold_seed(seed, _LAYERDROP_SITE)) < config.layerdrop)


def _encoder_pipelined(params, config: HubertConfig, hidden, frame_mask, dropout_seed, mesh,
                       microbatches: int):
    """The layer stack GPipe'd over ``mesh``'s pp axis (this stage's
    stacked layers), LayerDrop on the global layer index."""
    if frame_mask is None:
        frame_mask = torch.ones(hidden.shape[:2], dtype=torch.bool, device=hidden.device)

    def layer_fn(h, layer, idx, shard, mask):
        seed = fold_seed(dropout_seed, idx) if dropout_seed is not None else None
        if _dropped(config, seed):
            return h
        return _run_layer(layer, config, h, mask, seed, shard, mesh)

    return gpipe_apply(layer_fn, params["layers"], hidden, (frame_mask,), mesh,
                       num_layers=config.num_hidden_layers, microbatches=microbatches)


def encoder(params, config: HubertConfig, hidden: torch.Tensor,
            frame_mask: Optional[torch.Tensor],
            dropout_seed: Optional[int] = None, mesh=None,
            microbatches: int = 0) -> torch.Tensor:
    """Transformer encoder. ``dropout_seed`` selects train mode: hidden
    dropout after the positional conv, per-layer dropout, and LayerDrop
    (one draw per layer per call skips the whole layer for the batch).
    Under ``mesh``'s sp the layer stack runs on this rank's time slice;
    under its pp it is pipelined in ``microbatches`` (0: 2·pp)."""
    eps = config.layer_norm_eps
    shard = mesh.element_shard() if mesh is not None else None
    if frame_mask is not None:
        hidden = hidden * frame_mask[..., None].to(hidden.dtype)
    hidden = hidden + _pos_conv_embedding(params, config, hidden)
    if not config.do_stable_layer_norm:
        hidden = _layer_norm(hidden, params["encoder_layer_norm"], eps)
    if dropout_seed is not None:
        hidden = dropout(fold_seed(dropout_seed, _HIDDEN_SITE), hidden, config.hidden_dropout,
                         shard)
    t = hidden.shape[1]
    sequence_parallel = mesh is not None and mesh.size("sp") > 1
    if mesh is not None and mesh.size("pp") > 1:
        if sequence_parallel:
            raise ValueError("pipeline and sequence parallelism cannot nest in the encoder")
        hidden = _encoder_pipelined(params, config, hidden, frame_mask, dropout_seed, mesh,
                                    microbatches)
        if config.do_stable_layer_norm:
            hidden = _layer_norm(hidden, params["encoder_layer_norm"], eps)
        return hidden
    if sequence_parallel:
        if frame_mask is None:
            frame_mask = torch.ones(hidden.shape[:2], dtype=torch.bool, device=hidden.device)
        hidden = sequence.shard_time(hidden, mesh)
        frame_mask = sequence.shard_time(frame_mask, mesh)
        shard = mesh.element_shard(time=(mesh.index("sp") * hidden.shape[1], t))
    n = config.num_hidden_layers
    for idx, layer in enumerate(layer_seq(params["layers"], n)[:n]):
        seed = fold_seed(dropout_seed, idx) if dropout_seed is not None else None
        if _dropped(config, seed):
            continue
        hidden = _run_layer(layer, config, hidden, frame_mask, seed, shard, mesh)
    if sequence_parallel:
        hidden = sequence.gather_time(hidden, mesh, t)
    if config.do_stable_layer_norm:
        hidden = _layer_norm(hidden, params["encoder_layer_norm"], eps)
    return hidden


def hubert_encode(params: dict, config: HubertConfig, waveform: torch.Tensor,
                  attention_mask: Optional[torch.Tensor] = None,
                  dropout_seed: Optional[int] = None, mesh=None, microbatches: int = 0):
    """[B, L] waveforms → ([B, T, H] frames, [B, T] bool frame mask or None)
    (``HubertModel.forward`` with mask_time_prob=0). Passing an int32
    ``dropout_seed`` selects train mode; omitting it gives eval mode.
    ``mesh`` (the trainer's, or None) selects the tp, sp and pp routes;
    ``microbatches`` is the pipeline's count."""
    features = _conv_stack(params, config, waveform)
    frame_mask = None
    if attention_mask is not None:
        frame_mask = feature_vector_attention_mask(config, features.shape[1], attention_mask)
    fp = params["feature_projection"]
    hidden = _layer_norm(features, fp["layer_norm"], config.layer_norm_eps)
    hidden = _dense(hidden, fp["projection"])
    seed_enc = None
    if dropout_seed is not None:
        shard = mesh.element_shard() if mesh is not None else None
        hidden = dropout(fold_seed(dropout_seed, 0), hidden, config.feature_projection_dropout,
                         shard)
        seed_enc = fold_seed(dropout_seed, 1)
    return encoder(params, config, hidden, frame_mask, seed_enc, mesh, microbatches), frame_mask
