"""EfficientNet-b0 audio encoder (counterpart of
``aat_tpu/models/efficientnet.py``): per-segment mel-spectrograms ``[bs, 1,
n_mels, T]`` are repeated to 3 channels and run through EfficientNet-b0
without its classifier (stem conv → 16 MBConv blocks with
squeeze-excitation → 1x1 head conv → global average pool), giving
``[bs, 1, 1280]`` and an all-ones feature mask.

Parameters are the JAX package's tree with PyTorch's conv layout: kernels
``[C_out, C_in/groups, k, k]`` (OIHW; depthwise ``[mid, 1, k, k]``) where
JAX keeps HWIO; :mod:`aat_tpu_torch.utils.port` carries one into the
other. The draws are the JAX package's numpy draws (one
``default_rng(seed)``, He-normal), so a seed gives the same weights.
Activations are NCHW. Padding is TF-SAME, as JAX's ``padding="SAME"``
gives it: asymmetric at stride 2 (``F.pad``, then the convolution).
Convolutions are cuDNN's ``F.conv2d``, as the HuBERT convs are, under
PyTorch's TF32 default for cuDNN.

Batch norm runs in torch's two modes. Eval normalizes with the running
statistics. Train (the reference's HF Trainer keeps the model in
``.train()``, even with the encoder frozen) normalizes with the batch's:
statistics over (N, H, W) in float32, the biased variance normalizing at
the compute dtype, and the float32 mean and *unbiased* variance returned
detached, which :func:`apply_bn_updates` folds into the running
estimates (momentum 0.01, lukemelas b0's ``1 - batch_norm_momentum``). The
arithmetic is written out as JAX's is, not ``F.batch_norm``: the fused
kernel rounds otherwise and updates the running statistics in place.

Pretrained weights come from ``efficientnet_pytorch`` (a download); where
it is missing, :func:`build_efficientnet_encoder` warns and uses the
seeded random init, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from aat_tpu_torch.utils.port import encoder_from_jax, to_tensors

logger = logging.getLogger(__name__)

# (expand_ratio, channels, repeats, stride, kernel) per stage — b0.
_B0_BLOCKS = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]
_STEM_CH = 32
_HEAD_CH = 1280
_SE_RATIO = 0.25
_BN_EPS = 1e-3
BN_MOMENTUM = 0.01  # lukemelas b0: 1 - batch_norm_momentum (0.99)


@dataclasses.dataclass(frozen=True)
class EfficientNetConfig:
    hidden_size: int = _HEAD_CH
    in_channels: int = 3


def block_specs():
    """Per-block (stride, kernel, cin, cout, expand) of b0, outside the
    parameter tree."""
    specs = []
    cin = _STEM_CH
    for t, c, n, s, k in _B0_BLOCKS:
        for i in range(n):
            specs.append({"stride": s if i == 0 else 1, "kernel": k, "cin": cin, "cout": c,
                          "expand": t})
            cin = c
    return specs


def _conv_params(r, k, cin, cout, groups=1):
    fan = k * k * cin // groups
    return {"kernel": (r.normal(0, np.sqrt(2.0 / max(fan, 1)), (k, k, cin // groups, cout))
                       ).astype(np.float32)}


def _bn_params(c):
    return {"scale": np.ones((c,), np.float32), "bias": np.zeros((c,), np.float32),
            "mean": np.zeros((c,), np.float32), "var": np.ones((c,), np.float32)}


def init_efficientnet_numpy(seed: int = 0) -> dict:
    """The JAX package's ``init_efficientnet_params`` draws, in its HWIO
    layout, as numpy."""
    r = np.random.default_rng(seed)
    params: dict = {
        "stem": {"conv": _conv_params(r, 3, 3, _STEM_CH), "bn": _bn_params(_STEM_CH)},
        "blocks": [],
        "head": {"conv": _conv_params(r, 1, 320, _HEAD_CH), "bn": _bn_params(_HEAD_CH)},
    }
    for spec in block_specs():
        cin, c, t, k = spec["cin"], spec["cout"], spec["expand"], spec["kernel"]
        mid = cin * t
        p = {}
        if t != 1:
            p["expand_conv"] = _conv_params(r, 1, cin, mid)
            p["expand_bn"] = _bn_params(mid)
        p["dw_conv"] = _conv_params(r, k, mid, mid, groups=mid)
        p["dw_bn"] = _bn_params(mid)
        se = max(1, int(cin * _SE_RATIO))
        p["se_reduce"] = {"kernel": _conv_params(r, 1, mid, se)["kernel"],
                          "bias": np.zeros((se,), np.float32)}
        p["se_expand"] = {"kernel": _conv_params(r, 1, se, mid)["kernel"],
                          "bias": np.zeros((mid,), np.float32)}
        p["project_conv"] = _conv_params(r, 1, mid, c)
        p["project_bn"] = _bn_params(c)
        params["blocks"].append(p)
    return params


def init_efficientnet_params(seed: int = 0, device=None) -> dict:
    """Random init equal to the JAX package's ``init_efficientnet_params``
    of the same seed, in the port's layout."""
    return encoder_from_jax(init_efficientnet_numpy(seed), device)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def same_padding(size: int, k: int, stride: int):
    """TF-SAME padding of one axis: ``(low, high)``, the odd pixel high."""
    total = max((math.ceil(size / stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv2d(x, kernel, stride: int = 1, groups: int = 1):
    """TF-SAME convolution of NCHW ``x`` by an OIHW kernel, at ``x``'s dtype."""
    k = kernel.shape[-1]
    top, bottom = same_padding(x.shape[2], k, stride)
    left, right = same_padding(x.shape[3], k, stride)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, kernel.to(x.dtype), stride=stride, groups=groups)


def _per_channel(v):
    return v[None, :, None, None]


def _bn(x, p, batch_stats=None):
    """Eval BN (running statistics), or, given ``batch_stats=(mean, var)``,
    torch train-mode BN (the batch's biased statistics)."""
    mean, var = (p["mean"], p["var"]) if batch_stats is None else batch_stats
    inv = torch.rsqrt(var + _BN_EPS)
    return ((x - _per_channel(mean)) * _per_channel(inv) * _per_channel(p["scale"])
            + _per_channel(p["bias"]))


def _batch_stats(x):
    """Per-channel statistics over (N, H, W) in float32: (mean, biased var)
    at ``x``'s dtype to normalize, and the detached float32 (mean, unbiased
    var) for the running estimates."""
    xf = x.float()
    n = x.shape[0] * x.shape[2] * x.shape[3]
    mean = xf.mean((0, 2, 3))
    var = (xf - _per_channel(mean)).square().mean((0, 2, 3))
    unbiased = var * (n / max(n - 1, 1))
    return mean.to(x.dtype), var.to(x.dtype), mean.detach(), unbiased.detach()


def efficientnet_features(params: dict, images: torch.Tensor, train: bool = False):
    """``[B, 3, H, W]`` → ``[B, 1280]`` pooled features. ``train=True``
    normalizes every BN with the batch's statistics and returns
    ``(features, bn_stats)``, ``bn_stats`` mirroring the BN subtrees with
    the batch ``{mean, var}`` (var unbiased)."""
    stats: dict = {"stem": {}, "blocks": [], "head": {}}

    def bn(x, p, slot, key):
        if not train:
            return _bn(x, p)
        mean, var, mean32, unbiased = _batch_stats(x)
        slot[key] = {"mean": mean32, "var": unbiased}
        return _bn(x, p, batch_stats=(mean, var))

    x = F.silu(bn(_conv2d(images, params["stem"]["conv"]["kernel"], stride=2),
                  params["stem"]["bn"], stats["stem"], "bn"))
    for spec, p in zip(block_specs(), params["blocks"]):
        bstats: dict = {}
        inp = x
        if spec["expand"] != 1:
            x = F.silu(bn(_conv2d(x, p["expand_conv"]["kernel"]), p["expand_bn"], bstats,
                          "expand_bn"))
        mid = x.shape[1]
        x = F.silu(bn(_conv2d(x, p["dw_conv"]["kernel"], stride=spec["stride"], groups=mid),
                      p["dw_bn"], bstats, "dw_bn"))
        # squeeze-excitation
        se = x.mean((2, 3), keepdim=True)
        se = F.silu(_conv2d(se, p["se_reduce"]["kernel"]) + _per_channel(p["se_reduce"]["bias"]))
        se = torch.sigmoid(_conv2d(se, p["se_expand"]["kernel"])
                           + _per_channel(p["se_expand"]["bias"]))
        x = bn(_conv2d(x * se, p["project_conv"]["kernel"]), p["project_bn"], bstats,
               "project_bn")
        if spec["stride"] == 1 and spec["cin"] == spec["cout"]:
            x = x + inp
        stats["blocks"].append(bstats)
    x = F.silu(bn(_conv2d(x, params["head"]["conv"]["kernel"]), params["head"]["bn"],
                  stats["head"], "bn"))
    pooled = x.mean((2, 3))  # global average pool → [B, 1280]
    return (pooled, stats) if train else pooled


def apply_bn_updates(params: dict, bn_stats: dict, momentum: float = BN_MOMENTUM) -> dict:
    """The batch statistics of ``efficientnet_features(train=True)`` folded
    into the running estimates, ``running = (1-m)·running + m·batch`` in
    float32 (torch ``nn.BatchNorm2d``'s rule). Returns a new tree; every
    leaf but the BN ``mean``/``var`` is shared."""

    def merge(p, s):
        out = dict(p)
        for key, batch in s.items():
            b = dict(p[key])
            for name in ("mean", "var"):
                b[name] = (1.0 - momentum) * p[key][name].float() + momentum * batch[name]
            out[key] = b
        return out

    new = dict(params)
    new["stem"] = merge(params["stem"], bn_stats["stem"])
    new["head"] = merge(params["head"], bn_stats["head"])
    new["blocks"] = [merge(p, s) for p, s in zip(params["blocks"], bn_stats["blocks"])]
    return new


class EfficientNetAudioEncoderAdapter:
    """The reference's ``EfficientNetAudioEncdoerAdapter``: melspecs in,
    ``[bs, 1, 1280]`` out."""

    def __init__(self, config: EfficientNetConfig = EfficientNetConfig()):
        self.config = config
        self.hidden_size = config.hidden_size

    def __call__(self, params: dict, melspec: torch.Tensor, train: bool = False):
        """``[bs, 1, n_mels, T]`` (or ``[bs, n_mels, T]``) → ``[bs, 1,
        1280]``, with the batch BN statistics when ``train``."""
        if melspec.ndim == 3:
            melspec = melspec[:, None, :, :]
        images = melspec.repeat(1, 3, 1, 1)  # [bs, 3, n_mels, T]
        if train:
            feats, bn_stats = efficientnet_features(params, images, train=True)
            return feats[:, None, :], bn_stats
        return efficientnet_features(params, images)[:, None, :]

    @staticmethod
    def feature_vector_attention_mask(batch_size: int, device=None) -> torch.Tensor:
        return torch.ones((batch_size, 1), dtype=torch.bool, device=device)


def build_efficientnet_encoder(pretrained: bool = False, device=None):
    """→ (params, EfficientNetConfig). ``pretrained`` reads b0 through
    ``efficientnet_pytorch`` (which downloads); without that package it
    warns and uses the seeded random init (seed 0), as JAX does."""
    cfg = EfficientNetConfig()
    if pretrained:
        try:
            from efficientnet_pytorch import EfficientNet

            torch_model = EfficientNet.from_pretrained("efficientnet-b0").eval()
            return to_tensors(port_efficientnet(torch_model), device), cfg
        except ImportError:
            logger.warning("efficientnet_pytorch unavailable; using random init")
    return init_efficientnet_params(0, device), cfg


def port_efficientnet(source) -> dict:
    """lukemelas/EfficientNet-PyTorch b0 weights (the module, or its state
    dict) → the port's tree (float32 tensors; OIHW kernels as stored, the
    JAX package's ``port_efficientnet`` after the HWIO → OIHW carry). Keys:
    ``_conv_stem``, ``_bn0``, ``_blocks.{i}.`` (``_expand_conv``, ``_bn0``,
    ``_depthwise_conv``, ``_bn1``, ``_se_reduce``, ``_se_expand``,
    ``_project_conv``, ``_bn2``), ``_conv_head``, ``_bn1``; a missing key
    raises ``KeyError``."""
    if isinstance(source, Mapping):
        def get(name):
            if name not in source:
                raise KeyError(f"the b0 state dict has no tensor {name}")
            return source[name]
    else:
        def get(name):
            node = source
            for part in name.split("."):
                node = node[int(part)] if part.isdigit() else getattr(node, part)
            return node

    def t(name):
        return get(name).detach().to("cpu", torch.float32, copy=True).contiguous()

    def conv(name):
        return {"kernel": t(f"{name}.weight")}

    def bn(name):
        return {"scale": t(f"{name}.weight"), "bias": t(f"{name}.bias"),
                "mean": t(f"{name}.running_mean"), "var": t(f"{name}.running_var")}

    params: dict = {"stem": {"conv": conv("_conv_stem"), "bn": bn("_bn0")}, "blocks": []}
    for i, spec in enumerate(block_specs()):
        base = f"_blocks.{i}"
        p = {}
        if spec["expand"] != 1:
            p["expand_conv"] = conv(f"{base}._expand_conv")
            p["expand_bn"] = bn(f"{base}._bn0")
        p["dw_conv"] = conv(f"{base}._depthwise_conv")  # [mid, 1, k, k]
        p["dw_bn"] = bn(f"{base}._bn1")
        for key in ("se_reduce", "se_expand"):
            p[key] = {**conv(f"{base}._{key}"), "bias": t(f"{base}._{key}.bias")}
        p["project_conv"] = conv(f"{base}._project_conv")
        p["project_bn"] = bn(f"{base}._bn2")
        params["blocks"].append(p)
    params["head"] = {"conv": conv("_conv_head"), "bn": bn("_bn1")}
    return params
