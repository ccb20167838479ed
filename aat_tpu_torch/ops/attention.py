"""Attention (counterpart of ``aat_tpu/ops/attention.py``): the flash
kernels, their autograd, and the plain route.

:func:`attention_bthd` keeps the JAX dispatch: at ``T >=
MIN_PALLAS_SEQ_LEN`` with the kernel requested it runs
:func:`flash_attention_bthd`, below the gate the plain masked softmax.
The flash route is a ``torch.autograd.Function`` (the JAX ``_flash_core``
custom VJP):

- forward (replaces the TPU's ``_fwd_kernel`` and, causal,
  ``_fwd_tri_kernel``): both dtypes run on the tensor cores, bf16 operands
  through ``csrc/flash_fwd_mma.cu`` and f32 operands as 3xTF32 through
  ``csrc/flash_fwd_tf32x3.cu``; one wrapper and counter per TPU kernel
  covers both. It writes the row log-sum-exp when a gradient will be asked for;
  without one (serving, ``torch.no_grad``) the lse-free forward runs, as
  JAX's ``need_residuals=False`` does;
- backward: a dq kernel and a dk/dv kernel, both on the tensor cores, bf16
  operands through ``csrc/flash_bwd_mma.cu`` and f32 operands as 3xTF32
  through ``csrc/flash_bwd_tf32x3.cu``. For key lengths up to
  ``FUSED_BWD_MAX_S`` = 8192
  the wrappers
  :func:`flash_backward_kernel` / :func:`flash_backward_causal_kernel`
  launch both (replacing ``_bwd_fused_kernel`` and
  ``_bwd_fused_tri_kernel``); above it the split route's wrappers
  :func:`flash_backward_dq_long` and :func:`flash_backward_dkv_long` launch
  one each (replacing ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``). The
  kernels keep no S-sized state, so the two routes run the same code.

On a CPU tensor the dispatch takes the plain versions
(:func:`flash_forward_reference`, :func:`flash_backward_reference`); on a
CUDA tensor it launches the kernels or raises. The split route's kernels
have plain versions of their own (:func:`flash_backward_dq_reference`,
:func:`flash_backward_dkv_reference`) for the on-card checks, which hold
each kernel alone. Train-mode attention dropout
is the position hash of :mod:`aat_tpu_torch.ops.dropout`, keyed on the
flattened batch·head index, so kernel and plain routes drop the same
probabilities for the same int32 seed. ``head_keys = (heads_total,
head_offset)`` places the launch's H heads among ``heads_total`` heads of a
batch row, from ``head_offset`` on, and keys head h of row b on b·heads_total
+ head_offset + h: a tensor-parallel head shard draws the masks of those
heads of one device's launch. The default ``(H, 0)`` keys the launch's own
heads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from aat_tpu_torch.ops.dropout import head_seeds, keep_from_positions, to_int32
from aat_tpu_torch.runtime import kernels

NEG_INF = -1e30  # masked-score value of the plain route, and the lse of a dead row
MASK = -2e30  # masked-score value of the kernels; exp(MASK - NEG_INF) == 0
MIN_PALLAS_SEQ_LEN = 256  # the kernel engages at T >= this (JAX gate, same name)
# above this key length the backward takes the split route (the JAX
# ``_FUSED_BWD_MAX_S``): its own wrappers and counters, one per TPU kernel
FUSED_BWD_MAX_S = 8192


def _repeat_kv(k: torch.Tensor, v: torch.Tensor, n_heads: int, axis: int):
    if k.shape[axis] != n_heads:  # GQA: jnp.repeat == repeat_interleave
        rep = n_heads // k.shape[axis]
        k = torch.repeat_interleave(k, rep, dim=axis)
        v = torch.repeat_interleave(v, rep, dim=axis)
    return k, v


def _allowed(key_mask, t: int, s: int, causal: bool, pack_len: Optional[int]):
    """[B, 1, T, S] bool: key padding, and with ``causal`` the triangle and
    the ``pack_len`` block diagonal."""
    allowed = key_mask[:, None, None, :] > 0
    if causal:
        dev = key_mask.device
        q_pos = torch.arange(t, device=dev)[:, None]
        k_pos = torch.arange(s, device=dev)[None, :]
        ok = k_pos <= q_pos
        if pack_len is not None:
            ok = ok & (q_pos // pack_len == k_pos // pack_len)
        allowed = allowed & ok[None, None]
    return allowed


def _head_keys(h: int, head_keys: Optional[Tuple[int, int]]) -> Tuple[int, int]:
    """``(heads_total, head_offset)`` of a launch of ``h`` heads: ``(h, 0)``
    when None; raises unless the launch's heads lie among the total."""
    if head_keys is None:
        return h, 0
    total, offset = (int(x) for x in head_keys)
    if offset < 0 or offset + h > total:
        raise ValueError(f"head keys {head_keys} do not hold a launch of {h} heads")
    return total, offset


def _keep_mask(seed: int, b: int, h: int, t: int, s: int, rate: float, device,
               head_keys: Optional[Tuple[int, int]] = None):
    """[B, H, T, S] attention-dropout keep mask, head index b·heads_total +
    head_offset + h (``head_keys``, default ``(H, 0)``: b·H + h)."""
    seeds = head_seeds(seed, b * h, device, h, _head_keys(h, head_keys)).reshape(b, h, 1, 1)
    return keep_from_positions(seeds, torch.arange(t, device=device)[:, None],
                               torch.arange(s, device=device)[None, :], s, rate)


def _plain_forward(q, k, v, key_mask, sm_scale, causal, dropout_rate, dropout_seed,
                   pack_len, need_lse, head_keys=None):
    """``_reference_attention`` on ``[B, T, H, D]`` operands, plus the row
    log-sum-exp ``[B, H, T]`` when ``need_lse``."""
    b, t, h, _ = q.shape
    s = k.shape[1]
    k, v = _repeat_kv(k, v, h, axis=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    allowed = _allowed(key_mask, t, s, causal, pack_len)
    scores = torch.where(allowed, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    live = allowed.any(-1, keepdim=True)
    probs = torch.where(live, probs, torch.zeros_like(probs))
    lse = None
    if need_lse:
        lse = torch.logsumexp(scores, dim=-1)
        lse = torch.where(live[..., 0], lse, torch.full_like(lse, NEG_INF))
    if dropout_rate > 0.0 and dropout_seed is not None:
        keep = _keep_mask(dropout_seed, b, h, t, s, dropout_rate, q.device, head_keys)
        probs = torch.where(keep, probs / (1.0 - dropout_rate), torch.zeros_like(probs))
    probs = probs.to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)
    return out, lse


def reference_attention_bthd(q, k, v, key_mask, sm_scale: Optional[float] = None,
                             causal: bool = False, dropout_rate: float = 0.0,
                             dropout_seed: Optional[int] = None,
                             pack_len: Optional[int] = None,
                             head_keys: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Plain masked attention on ``[B, T, H, D]`` operands (the JAX
    ``_reference_attention`` / ``attention_bthd`` plain-branch semantics):
    f32 scores, masked to -1e30, softmax, fully masked rows zeroed, the
    position-hash dropout (divide by 1 - rate), probabilities cast to v's
    dtype, f32 products, result in q's dtype."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return _plain_forward(q, k, v, key_mask, sm_scale, causal, dropout_rate,
                          dropout_seed, pack_len, need_lse=False, head_keys=head_keys)[0]


def flash_forward_reference(q, k, v, key_mask, sm_scale: float, causal: bool = False,
                            dropout_rate: float = 0.0, dropout_seed: int = 0,
                            pack_len: Optional[int] = None,
                            head_keys: Optional[Tuple[int, int]] = None):
    """Plain version of the forward kernel: ``(out [B, T, H, D], lse
    [B, H, T] f32)``. A fully masked row has lse -1e30."""
    return _plain_forward(q, k, v, key_mask, sm_scale, causal, dropout_rate,
                          dropout_seed, pack_len, need_lse=True, head_keys=head_keys)


def _plain_ds(q, k, v, key_mask, out, lse, dout, sm_scale, causal, dropout_rate,
              dropout_seed, pack_len, head_keys=None):
    """The backward's shared core (``_ds_block`` semantics), ``[B, H, T, S]``
    f32: p = exp(q_s·k - lse) with q_s = round(q·sm_scale), delta =
    rowsum(dout·out), ds = p·(dp - delta) with dp masked and scaled by the
    dropout keep mask, and p_v, the dropped p that dv needs. Returns
    ``(ds, p_v, q_s, k_rep)``."""
    b, t, h, _ = q.shape
    s = k.shape[1]
    qs = (q.float() * sm_scale).to(q.dtype).float()
    kr, vr = _repeat_kv(k, v, h, axis=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", qs, kr.float())
    scores = torch.where(_allowed(key_mask, t, s, causal, pack_len), scores,
                         torch.full_like(scores, MASK))
    p = torch.exp(scores - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), vr.float())
    p_v = p
    if dropout_rate > 0.0:
        keep = _keep_mask(dropout_seed, b, h, t, s, dropout_rate, q.device, head_keys)
        inv = 1.0 / (1.0 - dropout_rate)
        p_v = torch.where(keep, p * inv, torch.zeros_like(p))
        dp = torch.where(keep, dp * inv, torch.zeros_like(dp))
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)  # [B, H, T]
    return p * (dp - delta[..., None]), p_v, qs, kr


def _plain_dq(q, k, ds, kr, sm_scale):
    return (torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kr.float())
            * sm_scale).to(q.dtype)


def _plain_dkv(q, k, v, dout, ds, p_v, qs):
    b, _, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), qs)
    dv = torch.einsum("bhqk,bqhd->bkhd", p_v.to(dout.dtype).float(), dout.float())
    rep = h // kvh
    dk = dk.reshape(b, s, kvh, rep, d).sum(3).to(k.dtype)
    dv = dv.reshape(b, s, kvh, rep, v.shape[-1]).sum(3).to(v.dtype)
    return dk, dv


def flash_backward_reference(q, k, v, key_mask, out, lse, dout, sm_scale: float,
                             causal: bool = False, dropout_rate: float = 0.0,
                             dropout_seed: int = 0, pack_len: Optional[int] = None,
                             head_keys: Optional[Tuple[int, int]] = None):
    """Plain version of the backward kernels: ``(dq, dk, dv)`` in the
    layouts and dtypes of q, k, v; dk/dv summed over the q-heads that share
    a kv head; ds rounded to the input dtype before each product, p_v to
    dout's."""
    ds, p_v, qs, kr = _plain_ds(q, k, v, key_mask, out, lse, dout, sm_scale, causal,
                                dropout_rate, dropout_seed, pack_len, head_keys)
    return (_plain_dq(q, k, ds, kr, sm_scale), *_plain_dkv(q, k, v, dout, ds, p_v, qs))


def flash_backward_dq_reference(q, k, v, key_mask, out, lse, dout, sm_scale: float,
                                causal: bool = False, dropout_rate: float = 0.0,
                                dropout_seed: int = 0, pack_len: Optional[int] = None,
                                head_keys: Optional[Tuple[int, int]] = None):
    """Plain version of the split route's dq kernel: dq alone."""
    ds, _, _, kr = _plain_ds(q, k, v, key_mask, out, lse, dout, sm_scale, causal,
                             dropout_rate, dropout_seed, pack_len, head_keys)
    return _plain_dq(q, k, ds, kr, sm_scale)


def flash_backward_dkv_reference(q, k, v, key_mask, out, lse, dout, sm_scale: float,
                                 causal: bool = False, dropout_rate: float = 0.0,
                                 dropout_seed: int = 0, pack_len: Optional[int] = None,
                                 head_keys: Optional[Tuple[int, int]] = None):
    """Plain version of the split route's dk/dv kernel: ``(dk, dv)``."""
    ds, p_v, qs, _ = _plain_ds(q, k, v, key_mask, out, lse, dout, sm_scale, causal,
                               dropout_rate, dropout_seed, pack_len, head_keys)
    return _plain_dkv(q, k, v, dout, ds, p_v, qs)


# ---------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)
# ---------------------------------------------------------------------------


# (q/k width, v width) the kernels are built for; latent attention's (192,
# 128) in bf16 and causal only
WIDTHS = ((64, 64), (128, 128), (192, 128))


def _check_operands(q, k, v, key_mask, causal):
    """Check the operands of a flash launch; returns the key mask as
    contiguous int32. Every flash kernel copies q/k/v rows in 16-byte
    ``cp.async`` chunks, so the strides must be multiples of 16 bytes (8
    bf16, 4 f32 elements) and the starts 16-byte aligned; anything else
    raises, with no fallback. q and k share a width D, v has DV
    (``WIDTHS``)."""
    kernels.check_cuda(q, "flash")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash kernel takes f32 or bf16, got {q.dtype}")
    b, t, h, d = q.shape
    _, s, kvh, _ = k.shape
    dv = v.shape[-1]
    if (k.shape != (b, s, kvh, d) or v.shape != (b, s, kvh, dv)
            or tuple(key_mask.shape) != (b, s)):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} mask {tuple(key_mask.shape)}")
    if (d, dv) not in WIDTHS or h % kvh:
        raise ValueError(f"flash kernel takes (D, DV) in {WIDTHS} and H % KVH == 0, "
                         f"got D={d} DV={dv} H={h} KVH={kvh}")
    if d != dv and (q.dtype != torch.bfloat16 or not causal):
        raise ValueError(f"flash kernel takes (D, DV) = ({d}, {dv}) in bf16 and causal only")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    label = "bf16" if q.dtype == torch.bfloat16 else "f32"
    chunk = 16 // q.element_size()  # elements of one 16-byte copy
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.stride(-1) != 1:
            raise ValueError(f"{name} must lie on {q.device} with a unit last stride")
        # (a stride of a size-1 axis is never used)
        if any(x.stride(i) % chunk for i in range(3) if x.shape[i] > 1):
            raise ValueError(f"{label} {name} needs strides in multiples of {chunk} elements, "
                             f"got {x.stride()}")
        if x.data_ptr() % 16:
            raise ValueError(f"{label} {name} must start on a 16-byte boundary")
    return key_mask.to(device=q.device, dtype=torch.int32).contiguous()


def _widths(q, v):
    return q.shape[-1], v.shape[-1]


def _strides(q, k, v):
    return (q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2))


def _dropout_args(dropout_rate: float, dropout_seed: int, h: int, head_keys):
    """seed, rate, inv_keep, heads_total, head_offset of a C entry."""
    rate = float(dropout_rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"flash kernel dropout rate must lie in [0, 1), got {rate}")
    return (to_int32(int(dropout_seed)), rate, 1.0 / (1.0 - rate) if rate > 0.0 else 1.0,
            *_head_keys(h, head_keys))


def _launch_forward(q, k, v, key_mask, sm_scale, causal, dropout_rate, dropout_seed,
                    pack_len, need_lse, head_keys):
    mask = _check_operands(q, k, v, key_mask, causal)
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    out = torch.empty((b, t, h, v.shape[-1]), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, t), dtype=torch.float32, device=q.device)
           if need_lse else None)
    kernels.launch(
        "aat_flash_fwd_mma" if q.dtype == torch.bfloat16 else "aat_flash_fwd_tf32x3",
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), lse.data_ptr() if need_lse else None, b, t, s, h, kvh, *_widths(q, v),
        *_strides(q, k, v),
        float(sm_scale), int(causal), int(pack_len or 0),
        *_dropout_args(dropout_rate, dropout_seed, h, head_keys))
    return (out, lse) if need_lse else out


def flash_forward_kernel(q, k, v, key_mask, sm_scale: float, dropout_rate: float = 0.0,
                         dropout_seed: int = 0, need_lse: bool = False,
                         head_keys: Optional[Tuple[int, int]] = None):
    """Launch the dense forward, ``aat_flash_fwd_mma`` in bf16 and
    ``aat_flash_fwd_tf32x3`` in f32 (replaces the TPU kernel
    aat_tpu/ops/attention.py:186 ``_fwd_kernel``) → out ``[B, T, H, D]`` in
    q's dtype, or ``(out, lse [B, H, T] f32)`` with ``need_lse``."""
    result = _launch_forward(q, k, v, key_mask, sm_scale, False, dropout_rate,
                             dropout_seed, None, need_lse, head_keys)
    flash_forward_kernel.launches += 1
    return result


def flash_forward_causal_kernel(q, k, v, key_mask, sm_scale: float,
                                dropout_rate: float = 0.0, dropout_seed: int = 0,
                                pack_len: Optional[int] = None, need_lse: bool = False,
                                head_keys: Optional[Tuple[int, int]] = None):
    """Launch the causal forward, ``aat_flash_fwd_mma`` in bf16 and
    ``aat_flash_fwd_tf32x3`` in f32 (replaces the TPU kernel
    aat_tpu/ops/attention.py:245 ``_fwd_tri_kernel``)."""
    result = _launch_forward(q, k, v, key_mask, sm_scale, True, dropout_rate,
                             dropout_seed, pack_len, need_lse, head_keys)
    flash_forward_causal_kernel.launches += 1
    return result


def _backward_operands(q, k, v, key_mask, out, lse, dout, causal):
    mask = _check_operands(q, k, v, key_mask, causal)
    b, t, h, _ = q.shape
    out = out.contiguous()
    dout = dout.to(q.dtype).contiguous()
    lse = lse.contiguous()
    want = (b, t, h, v.shape[-1])
    if out.shape != want or dout.shape != want or lse.shape != (b, h, t):
        raise ValueError(f"out {tuple(out.shape)} dout {tuple(dout.shape)} "
                         f"lse {tuple(lse.shape)} do not fit q {tuple(q.shape)}")
    # the kernels copy dout rows in 16-byte chunks, and the bf16 ones out's
    # too (the 3xTF32 kernels read out with 4-byte loads)
    for name, x in (("out", out), ("dout", dout)):
        if x.data_ptr() % 16 and (name == "dout" or q.dtype == torch.bfloat16):
            raise ValueError(f"{'bf16' if q.dtype == torch.bfloat16 else 'f32'} {name} must "
                             "start on a 16-byte boundary")
    return mask, out, lse, dout


def _backward_args(q, k, v, sm_scale, causal, dropout_rate, dropout_seed, pack_len,
                   head_keys):
    """The C entries' arguments after the output pointers, up to the
    stream, which :func:`kernels.launch` appends."""
    b, t, h, _ = q.shape
    s, kvh = k.shape[1], k.shape[2]
    return (b, t, s, h, kvh, *_widths(q, v), *_strides(q, k, v),
            float(sm_scale), int(causal), int(pack_len or 0),
            *_dropout_args(dropout_rate, dropout_seed, h, head_keys))


def _launch_backward_dq(q, k, v, key_mask, out, lse, dout, sm_scale, causal, dropout_rate,
                        dropout_seed, pack_len, head_keys):
    """``aat_flash_bwd_dq_mma`` in bf16, ``aat_flash_bwd_dq_tf32x3`` in f32
    → dq ``[B, T, H, D]`` in q's dtype."""
    mask, out, lse, dout = _backward_operands(q, k, v, key_mask, out, lse, dout, causal)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    kernels.launch(
        "aat_flash_bwd_dq_mma" if q.dtype == torch.bfloat16 else "aat_flash_bwd_dq_tf32x3",
        q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), dq.data_ptr(),
        *_backward_args(q, k, v, sm_scale, causal, dropout_rate, dropout_seed, pack_len,
                        head_keys))
    return dq


def _launch_backward_dkv(q, k, v, key_mask, out, lse, dout, sm_scale, causal,
                         dropout_rate, dropout_seed, pack_len, head_keys):
    """``aat_flash_bwd_dkv_mma`` in bf16, ``aat_flash_bwd_dkv_tf32x3`` in
    f32 → ``(dk, dv)`` in k's layout and dtype: the kernel writes them per
    q-head in f32, and the q-heads that share a kv head (GQA) are summed
    here in f32. Either entry fills a ``[B, H, T]`` f32 scratch with delta =
    rowsum(dout·out) first."""
    mask, out, lse, dout = _backward_operands(q, k, v, key_mask, out, lse, dout, causal)
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    dk_rep = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    dv_rep = torch.empty((b, s, h, v.shape[-1]), dtype=torch.float32, device=q.device)
    delta = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    kernels.launch(
        "aat_flash_bwd_dkv_mma" if q.dtype == torch.bfloat16 else "aat_flash_bwd_dkv_tf32x3",
        q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), dk_rep.data_ptr(), dv_rep.data_ptr(),
        delta.data_ptr(),
        *_backward_args(q, k, v, sm_scale, causal, dropout_rate, dropout_seed, pack_len,
                        head_keys))
    rep = h // kvh
    dk = dk_rep.reshape(b, s, kvh, rep, d).sum(3).to(k.dtype)
    dv = dv_rep.reshape(b, s, kvh, rep, v.shape[-1]).sum(3).to(v.dtype)
    return dk, dv


def _launch_backward(q, k, v, key_mask, out, lse, dout, sm_scale, causal, dropout_rate,
                     dropout_seed, pack_len, head_keys):
    args = (q, k, v, key_mask, out, lse, dout, sm_scale, causal, dropout_rate,
            dropout_seed, pack_len, head_keys)
    return (_launch_backward_dq(*args), *_launch_backward_dkv(*args))


def flash_backward_kernel(q, k, v, key_mask, out, lse, dout, sm_scale: float,
                          dropout_rate: float = 0.0, dropout_seed: int = 0,
                          head_keys: Optional[Tuple[int, int]] = None):
    """Launch the dq and dk/dv kernels, dense, on the tensor cores (bf16,
    and f32 as 3xTF32) (replaces the TPU kernel
    aat_tpu/ops/attention.py:764 ``_bwd_fused_kernel``) → ``(dq, dk, dv)``."""
    grads = _launch_backward(q, k, v, key_mask, out, lse, dout, sm_scale, False,
                             dropout_rate, dropout_seed, None, head_keys)
    flash_backward_kernel.launches += 1
    return grads


def flash_backward_causal_kernel(q, k, v, key_mask, out, lse, dout, sm_scale: float,
                                 dropout_rate: float = 0.0, dropout_seed: int = 0,
                                 pack_len: Optional[int] = None,
                                 head_keys: Optional[Tuple[int, int]] = None):
    """Launch the dq and dk/dv kernels, causal (replaces the TPU kernel
    aat_tpu/ops/attention.py:709 ``_bwd_fused_tri_kernel``)."""
    grads = _launch_backward(q, k, v, key_mask, out, lse, dout, sm_scale, True,
                             dropout_rate, dropout_seed, pack_len, head_keys)
    flash_backward_causal_kernel.launches += 1
    return grads


def flash_backward_dq_long(q, k, v, key_mask, out, lse, dout, sm_scale: float,
                           causal: bool = False, dropout_rate: float = 0.0,
                           dropout_seed: int = 0, pack_len: Optional[int] = None,
                           head_keys: Optional[Tuple[int, int]] = None):
    """Launch the dq kernel, the dq half of the split route for key
    lengths above ``FUSED_BWD_MAX_S``, dense or causal (replaces the TPU
    kernel aat_tpu/ops/attention.py:562 ``_bwd_dq_kernel``) → dq."""
    dq = _launch_backward_dq(q, k, v, key_mask, out, lse, dout, sm_scale, causal,
                             dropout_rate, dropout_seed, pack_len, head_keys)
    flash_backward_dq_long.launches += 1
    return dq


def flash_backward_dkv_long(q, k, v, key_mask, out, lse, dout, sm_scale: float,
                            causal: bool = False, dropout_rate: float = 0.0,
                            dropout_seed: int = 0, pack_len: Optional[int] = None,
                            head_keys: Optional[Tuple[int, int]] = None):
    """Launch the dk/dv kernel, the dk/dv half of the split route,
    dense or causal (replaces the TPU kernel aat_tpu/ops/attention.py:595
    ``_bwd_dkv_kernel``) → ``(dk, dv)``."""
    grads = _launch_backward_dkv(q, k, v, key_mask, out, lse, dout, sm_scale, causal,
                                 dropout_rate, dropout_seed, pack_len, head_keys)
    flash_backward_dkv_long.launches += 1
    return grads


for _wrapper in (flash_forward_kernel, flash_forward_causal_kernel,
                 flash_backward_kernel, flash_backward_causal_kernel,
                 flash_backward_dq_long, flash_backward_dkv_long):
    _wrapper.launches = 0


# ---------------------------------------------------------------------------
# dispatch and autograd
# ---------------------------------------------------------------------------


def flash_forward(q, k, v, key_mask, sm_scale, causal, dropout_rate, dropout_seed,
                  pack_len, need_lse, head_keys=None):
    """The forward: plain version on a CPU tensor, kernel on a CUDA one.
    Returns out, or ``(out, lse)`` with ``need_lse``."""
    if q.device.type == "cpu":
        out, lse = _plain_forward(q, k, v, key_mask, sm_scale, causal, dropout_rate,
                                  dropout_seed, pack_len, need_lse, head_keys)
        return (out, lse) if need_lse else out
    if causal:
        return flash_forward_causal_kernel(q, k, v, key_mask, sm_scale, dropout_rate,
                                           dropout_seed, pack_len, need_lse, head_keys)
    return flash_forward_kernel(q, k, v, key_mask, sm_scale, dropout_rate, dropout_seed,
                                need_lse, head_keys)


def flash_backward(q, k, v, key_mask, out, lse, dout, sm_scale, causal, dropout_rate,
                   dropout_seed, pack_len, head_keys=None):
    """The backward: the plain version on a CPU tensor, kernels on a CUDA
    one. There, key lengths above ``FUSED_BWD_MAX_S`` take the split route,
    a dq pass and a dk/dv pass (the JAX ``_flash_backward`` dispatch)."""
    args = (q, k, v, key_mask, out, lse, dout, sm_scale, causal, dropout_rate,
            dropout_seed, pack_len, head_keys)
    if q.device.type == "cpu":
        return flash_backward_reference(*args)
    if k.shape[1] > FUSED_BWD_MAX_S:
        return (flash_backward_dq_long(*args), *flash_backward_dkv_long(*args))
    if causal:
        return flash_backward_causal_kernel(q, k, v, key_mask, out, lse, dout, sm_scale,
                                            dropout_rate, dropout_seed, pack_len, head_keys)
    return flash_backward_kernel(q, k, v, key_mask, out, lse, dout, sm_scale,
                                 dropout_rate, dropout_seed, head_keys)


class _FlashCore(torch.autograd.Function):
    """``_flash_core``'s custom VJP. The backward runs whenever any of q, k,
    v needs a gradient: through a frozen LM the parameters need none, but
    the activations feeding q, k, v do."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, sm_scale, causal, dropout_rate, dropout_seed,
                pack_len, head_keys):
        out, lse = flash_forward(q, k, v, key_mask, sm_scale, causal, dropout_rate,
                                 dropout_seed, pack_len, True, head_keys)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.config = (sm_scale, causal, dropout_rate, dropout_seed, pack_len, head_keys)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, key_mask, out, lse, dout, *ctx.config)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention_bthd(q, k, v, key_mask, causal: bool = False,
                         sm_scale: Optional[float] = None, dropout_rate: float = 0.0,
                         dropout_seed: Optional[int] = None,
                         pack_len: Optional[int] = None,
                         head_keys: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Flash attention: q ``[B, T, H, D]``, k ``[B, S, KVH, D]``, v ``[B, S,
    KVH, DV]``, key_mask ``[B, S]`` → ``[B, T, H, DV]`` in q's dtype (DV = D
    but for latent attention's causal (192, 128), ``WIDTHS``). Dropout applies only with a
    seed (no seed: eval mode). ``pack_len``: rows are packed utterances of
    that many tokens, attention blocked across them (causal only).
    ``head_keys``: the dropout hash's ``(heads_total, head_offset)``
    (module docstring)."""
    if pack_len is not None and not causal:
        raise ValueError("sequence packing (pack_len) requires causal attention")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    rate = float(dropout_rate) if dropout_seed is not None else 0.0
    seed = int(dropout_seed) if dropout_seed is not None else 0
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashCore.apply(q, k, v, key_mask, sm_scale, causal, rate, seed, pack_len,
                                head_keys)
    return flash_forward(q, k, v, key_mask, sm_scale, causal, rate, seed, pack_len,
                         need_lse=False, head_keys=head_keys)


def flash_attention(q, k, v, key_mask, causal: bool = False,
                    sm_scale: Optional[float] = None, dropout_rate: float = 0.0,
                    dropout_seed: Optional[int] = None, pack_len: Optional[int] = None):
    """The JAX ``flash_attention`` layout: q ``[B, H, T, D]``, k/v
    ``[B, KVH, S, D]``. The kernels read strides, so the transposes are
    views, not copies."""
    out = flash_attention_bthd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                               key_mask, causal, sm_scale, dropout_rate, dropout_seed,
                               pack_len)
    return out.transpose(1, 2)


def attention_bthd(q, k, v, key_mask, causal: bool = False,
                   sm_scale: Optional[float] = None, use_kernel: bool = True,
                   dropout_rate: float = 0.0, dropout_seed: Optional[int] = None,
                   head_keys: Optional[Tuple[int, int]] = None):
    """``[B, T, H, D]`` attention with the JAX dispatch: the flash route at
    ``T >= MIN_PALLAS_SEQ_LEN`` when ``use_kernel``, the plain route
    otherwise (at segment lengths, T~12, one batched softmax beats a
    kernel launch per tile). Both routes drop the same probabilities for
    the same seed and ``head_keys``."""
    if use_kernel and q.shape[1] >= MIN_PALLAS_SEQ_LEN:
        return flash_attention_bthd(q, k, v, key_mask, causal, sm_scale, dropout_rate,
                                    dropout_seed, head_keys=head_keys)
    return reference_attention_bthd(q, k, v, key_mask, sm_scale, causal, dropout_rate,
                                    dropout_seed, head_keys=head_keys)
