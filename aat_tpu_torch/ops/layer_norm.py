"""Layer norm over the last axis (HuBERT's ``_layer_norm``, the
``transformer_encoder`` projection's norms): per vector, in f32, the mean,
the variance as the mean of squared deviations, ``(x − mean)·rsqrt(var +
eps)·scale + bias``, rounded once to x's dtype; ``scale`` and ``bias`` are
read in their own dtype and widened.

On a CUDA tensor it runs as one hand-written kernel pair
(``csrc/layer_norm.cu``): ``aat_layer_norm_fwd`` reads x once and writes y
once, and saves for the backward only x and each vector's f32 mean and
rstd (nothing when no gradient is wanted); ``aat_layer_norm_bwd`` writes dx
in one pass and dscale and dbias through per-block partials summed in a
fixed order (no atomics: the same bits every run). The layout is read from
x's strides: rows (C contiguous), or the transposed view of a contiguous
``[B, C, T]`` (the conv stack's output), which the kernel normalises over C
where it lies, so the transposes around the norm stay views (its y is the
same view of rows padded to whole 128-byte lines). A CPU tensor
takes :func:`layer_norm_reference`, the f32 composite that the kernel is
held to on the card.
"""

from __future__ import annotations

import torch

from aat_tpu_torch.runtime import kernels
from aat_tpu_torch.utils import timing

# the kernels' dtype codes (csrc/layer_norm.cu), for x and for scale/bias
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROWS, CHANNELS_FIRST = 0, 1
ROWS_MAX_C = 4096  # the rows kernels: a multiple of 8 up to this
CHANNELS_FIRST_MAX_C = 512  # the channel-first kernels: a multiple of 32 up to this
PARTIALS = 512  # backward blocks at most: rows of the dscale/dbias scratch
# a channel-first y's rows are padded to this many elements, so that each
# row, and each of the kernel's 64-position tiles in it, starts on a
# 128-byte line: a store that fills a 32-byte sector in part costs the card
# far more than a whole one (about 2x the forward's time at odd T)
ROW_PAD = 64


def layer_norm_reference(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                         eps: float) -> torch.Tensor:
    """The plain version: the route of a CPU tensor, and what the kernel is
    held to on the card. Computes in f32 (in f64 for f64 x)."""
    acc = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(acc)
    mean = x32.mean(-1, keepdim=True)
    var = ((x32 - mean) ** 2).mean(-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps) * scale.to(acc)
    return (out + bias.to(acc)).to(x.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary (the rows
    kernels' vector accesses): a copy where it is not."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _plan(x: torch.Tensor):
    """``(layout, base, (outer, C, T))``: the tensor the kernel walks.
    Channel-first where x is the transposed view of a contiguous ``[B, C,
    T]`` whose C the channel-first kernels take; rows otherwise (a copy
    where x's rows are not contiguous)."""
    c = x.shape[-1]
    if (x.dim() == 3 and not x.is_contiguous() and x.transpose(1, 2).is_contiguous()
            and c % 32 == 0 and c <= CHANNELS_FIRST_MAX_C):
        return CHANNELS_FIRST, x.transpose(1, 2), (x.shape[0], c, x.shape[1])
    if c % 8 or not 8 <= c <= ROWS_MAX_C:
        raise ValueError(f"the layer norm kernel takes widths that are multiples of 8 up to "
                         f"{ROWS_MAX_C}, got {c}")
    return ROWS, _aligned(x), (x.numel() // c, c, 1)


def _unplan(t: torch.Tensor, layout: int) -> torch.Tensor:
    return t.transpose(1, 2) if layout == CHANNELS_FIRST else t


def _check(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    kernels.check_cuda(x, "layer norm")
    if x.dtype not in _DTYPES:
        raise ValueError(f"the layer norm kernel takes x in {list(_DTYPES)}, got {x.dtype}")
    if scale.dtype not in _DTYPES or bias.dtype != scale.dtype:
        raise ValueError(f"the layer norm kernel takes scale and bias of one dtype in "
                         f"{list(_DTYPES)}, got {scale.dtype} and {bias.dtype}")
    if scale.shape != (x.shape[-1],) or bias.shape != scale.shape:
        raise ValueError(f"scale {tuple(scale.shape)} and bias {tuple(bias.shape)} do not "
                         f"match x's last axis {x.shape[-1]}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _output(base, layout, dims):
    """The forward's y as the kernel walks it and its channel-row stride: a
    channel-first y is a view of ``[B, C, T]`` rows padded to ``ROW_PAD``."""
    if layout == ROWS:
        return torch.empty_like(base, memory_format=torch.contiguous_format), dims[1]
    ldy = -(-dims[2] // ROW_PAD) * ROW_PAD
    padded = torch.empty((dims[0], dims[1], ldy), dtype=base.dtype, device=base.device)
    return padded[..., :dims[2]], ldy


def _forward(x, scale, bias, eps, stats: bool):
    """The forward launch: y, then the layout, the tensor the kernel read
    (x as it walks it), its dims, the scale it read, and the mean and rstd
    (None unless ``stats``)."""
    layout, base, dims = _plan(x)
    scale, bias = _aligned(scale), _aligned(bias)
    y, ldy = _output(base, layout, dims)
    mean = rstd = None
    if stats:
        mean, rstd = (torch.empty(dims[0] * dims[2], dtype=torch.float32, device=x.device)
                      for _ in range(2))
    kernels.launch("aat_layer_norm_fwd", x.device, base.data_ptr(), y.data_ptr(),
                   scale.data_ptr(), bias.data_ptr(), _ptr(mean), _ptr(rstd), _DTYPES[x.dtype],
                   _DTYPES[scale.dtype], layout, *dims, ldy, float(eps))
    return _unplan(y, layout), layout, base, dims, scale, mean, rstd


def _backward(base, dy, scale, mean, rstd, layout, dims, param_grads: bool):
    """The backward launch on the forward's saved state: dx as x lies, and
    dscale and dbias in the parameters' dtype where ``param_grads``."""
    dy = _aligned(dy.transpose(1, 2) if layout == CHANNELS_FIRST else dy)
    dx = torch.empty_like(base, memory_format=torch.contiguous_format)
    dscale = dbias = partials = None
    if param_grads:
        dscale, dbias = (torch.empty(dims[1], dtype=scale.dtype, device=dx.device)
                         for _ in range(2))
        partials = torch.empty((PARTIALS, 2, dims[1]), dtype=torch.float32, device=dx.device)
    kernels.launch("aat_layer_norm_bwd", dx.device, base.data_ptr(), dy.data_ptr(),
                   scale.data_ptr(), mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
                   _ptr(dscale), _ptr(dbias), _ptr(partials), PARTIALS, _DTYPES[dx.dtype],
                   _DTYPES[scale.dtype], layout, *dims)
    return _unplan(dx, layout), dscale, dbias


class _LayerNorm(torch.autograd.Function):
    """The kernel pair; saves x (as the kernel walks it), the scale it read
    and the f32 mean and rstd."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, layout, base, dims, scale, mean, rstd = _forward(x, scale, bias, eps, stats=True)
        ctx.save_for_backward(base, scale, mean, rstd)
        ctx.layout, ctx.dims = layout, dims
        return y

    @staticmethod
    def backward(ctx, dy):
        base, scale, mean, rstd = ctx.saved_tensors
        wants = ctx.needs_input_grad
        with timing.span("ops.layer_norm", device=True):
            dx, dscale, dbias = _backward(base, dy, scale, mean, rstd, ctx.layout, ctx.dims,
                                          wants[1] or wants[2])
        return dx, dscale if wants[1] else None, dbias if wants[2] else None, None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Layer norm of x over its last axis. A CPU tensor takes
    :func:`layer_norm_reference`; any other the kernel pair, which raises on
    what it does not take (no fallback)."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, scale, bias, eps)
    _check(x, scale, bias)
    with timing.span("ops.layer_norm", device=True):
        if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                        or bias.requires_grad):
            return _LayerNorm.apply(x, scale, bias, eps)
        return _forward(x, scale, bias, eps, stats=False)[0]
