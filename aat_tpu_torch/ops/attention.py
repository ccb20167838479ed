"""Attention (counterpart of ``aat_tpu/ops/attention.py``): the dense
flash-attention forward kernel and the plain route.

:func:`attention_bthd` keeps the JAX dispatch: at ``T >=
MIN_PALLAS_SEQ_LEN`` with the kernel requested it runs
:func:`flash_attention_bthd`, whose CUDA kernel (``csrc/flash_fwd.cu``)
replaces the TPU's ``_fwd_kernel``; below the gate it runs the plain
masked softmax. On a CPU tensor the kernel wrapper takes its plain version
(:func:`reference_attention_bthd`); on a CUDA tensor it launches the kernel
or raises.

Not ported yet: the causal forward, the backward kernels and train-mode
attention dropout (the position hash). Asking for them raises.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # masked-score value of the plain route (the JAX reference's)
MIN_PALLAS_SEQ_LEN = 256  # the kernel engages at T >= this (JAX gate, same name)


def _repeat_kv(k: torch.Tensor, v: torch.Tensor, n_heads: int, axis: int):
    if k.shape[axis] != n_heads:  # GQA: jnp.repeat == repeat_interleave
        rep = n_heads // k.shape[axis]
        k = torch.repeat_interleave(k, rep, dim=axis)
        v = torch.repeat_interleave(v, rep, dim=axis)
    return k, v


def reference_attention_bthd(q, k, v, key_mask, sm_scale: Optional[float] = None,
                             causal: bool = False) -> torch.Tensor:
    """Plain masked attention on ``[B, T, H, D]`` operands (the JAX
    ``_reference_attention`` / ``attention_bthd`` plain-branch semantics):
    f32 scores, masked to -1e30, softmax, fully masked rows zeroed,
    probabilities cast to v's dtype, f32 products, result in q's dtype."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    k, v = _repeat_kv(k, v, q.shape[2], axis=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    allowed = key_mask[:, None, None, :] > 0
    if causal:
        t, s = scores.shape[-2], scores.shape[-1]
        allowed = allowed & (torch.arange(s, device=q.device)[None, :]
                             <= torch.arange(t, device=q.device)[:, None])[None, None]
    scores = torch.where(allowed, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(allowed.any(-1, keepdim=True), probs, torch.zeros_like(probs))
    probs = probs.to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)


def flash_attention_bthd(q, k, v, key_mask, causal: bool = False,
                         sm_scale: Optional[float] = None,
                         dropout_rate: float = 0.0) -> torch.Tensor:
    """Dense flash-attention forward: q ``[B, T, H, D]``, k/v ``[B, S, KVH,
    D]``, key_mask ``[B, S]`` → ``[B, T, H, D]`` in q's dtype."""
    if causal:
        raise NotImplementedError(
            "the causal flash kernel (aat_tpu/ops/attention.py:245 "
            "_fwd_tri_kernel) is not ported yet")
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "train-mode attention dropout (the position hash) is not ported yet")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return reference_attention_bthd(q, k, v, key_mask, sm_scale)
    return flash_forward_kernel(q, k, v, key_mask, sm_scale)


def flash_forward_kernel(q, k, v, key_mask, sm_scale: float) -> torch.Tensor:
    """Launch ``aat_flash_fwd`` (replaces the TPU kernel
    aat_tpu/ops/attention.py:186 ``_fwd_kernel``, non-causal) → out
    ``[B, T, H, D]`` in q's dtype."""
    from aat_tpu_torch.runtime.kernels import library, stream_handle

    if q.device.type != "cuda":
        raise ValueError(f"flash kernel needs CUDA tensors, got {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash kernel takes f32 or bf16, got {q.dtype}")
    b, t, h, d = q.shape
    _, s, kvh, _ = k.shape
    if (k.shape != (b, s, kvh, d) or v.shape != k.shape
            or tuple(key_mask.shape) != (b, s)):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} mask {tuple(key_mask.shape)}")
    if d not in (64, 128) or h % kvh:
        raise ValueError(f"flash kernel takes D in (64, 128) and H % KVH == 0, "
                         f"got D={d} H={h} KVH={kvh}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.stride(-1) != 1:
            raise ValueError(f"{name} must lie on {q.device} with a unit last stride")
    mask = key_mask.to(device=q.device, dtype=torch.int32).contiguous()
    out = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    library().call(
        "aat_flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), int(q.dtype == torch.bfloat16), b, t, s, h, kvh, d,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), float(sm_scale),
        stream_handle(q.device))
    flash_forward_kernel.launches += 1
    return out


flash_forward_kernel.launches = 0


def flash_attention(q, k, v, key_mask, causal: bool = False,
                    sm_scale: Optional[float] = None, dropout_rate: float = 0.0):
    """The JAX ``flash_attention`` layout: q ``[B, H, T, D]``, k/v
    ``[B, KVH, S, D]``. The kernel reads strides, so the transposes are
    views, not copies."""
    out = flash_attention_bthd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), key_mask, causal, sm_scale,
                               dropout_rate)
    return out.transpose(1, 2)


def attention_bthd(q, k, v, key_mask, causal: bool = False,
                   sm_scale: Optional[float] = None, use_kernel: bool = True):
    """``[B, T, H, D]`` attention with the JAX dispatch: the flash kernel at
    ``T >= MIN_PALLAS_SEQ_LEN`` when ``use_kernel``, the plain route
    otherwise (at segment lengths, T~12, one batched softmax beats a
    kernel launch per tile)."""
    if use_kernel and q.shape[1] >= MIN_PALLAS_SEQ_LEN:
        return flash_attention_bthd(q, k, v, key_mask, causal, sm_scale)
    return reference_attention_bthd(q, k, v, key_mask, sm_scale, causal)
