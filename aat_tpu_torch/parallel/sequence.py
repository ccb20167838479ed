"""Sequence parallelism for whole-utterance encoding, Ulysses-style
(counterpart of ``aat_tpu/parallel/sequence.py``).

Between layers the encoder's activations shard time over the mesh's
``sp`` axis (:func:`shard_time` pads T to a multiple of sp, the padded
frames masked, and keeps this rank's slice; :func:`gather_time` puts the
slices back together). Layer norms, the feed-forward and the projections
are position-wise, so they run on the slice. Attention needs every key:
:func:`ulysses_attention_bthd` re-shards with two all-to-alls (time-sharded
→ head-sharded and back, the DeepSpeed-Ulysses recipe), so each rank runs
:func:`~aat_tpu_torch.ops.attention.attention_bthd` (the flash kernels on
CUDA) over the full T for its H/sp heads.

The attention dropout hash keys on the kernel-local head index, so the
seed is salted by the sp index (``0x27D4EB2F``, as JAX salts it): each
head group's masks are distinct from the other ranks', and not those of a
one-device run. Under tensor parallelism too, the tp rank's global head
keys pass through under the salt, scaled to the launch's H/sp heads, so
the tp ranks of one sp index draw distinct masks (with tp = 1 the launch
keys its own heads, JAX's recipe). The other dropout sites key on global
positions (:class:`~aat_tpu_torch.ops.dropout.ElementShard`) and match one
device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from aat_tpu_torch.ops.attention import attention_bthd
from aat_tpu_torch.ops.dropout import to_int32
from aat_tpu_torch.parallel import comm

SP_SEED_SALT = 0x27D4EB2F


def shard_time(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's time slice (dim 1) of an activation that every sp rank
    holds whole, padded with zeros to a multiple of sp. The gradient comes
    back whole on every sp rank (all-gathered)."""
    sp = mesh.size("sp")
    t = x.shape[1]
    pad = -(-t // sp) * sp - t
    if pad:
        x = F.pad(x, (0, 0) * (x.ndim - 2) + (0, pad))
    return comm.scatter_to_group(x, mesh.group("sp"), 1)


def gather_time(x: torch.Tensor, mesh, t: int) -> torch.Tensor:
    """The time slices of every sp rank, concatenated and cut to ``t``; each
    rank's gradient is its own slice of the (replicated) one."""
    return comm.gather_from_group(x, mesh.group("sp"), 1)[:, :t]


def ulysses_attention_bthd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_mask: torch.Tensor, mesh, *, sm_scale: Optional[float] = None,
                           use_kernel: bool = True, dropout_rate: float = 0.0,
                           dropout_seed: Optional[int] = None,
                           head_keys: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Attention over time-sharded operands: q/k/v ``[B, T/sp, H, D]`` and
    the key mask ``[B, T/sp]`` of this rank's slice → ``[B, T/sp, H, D]``.
    H must divide by sp (tensor parallelism has already cut it to this
    rank's heads, whose dropout keys are ``head_keys``). With sp = 1 this is
    plain ``attention_bthd``."""
    group = mesh.group("sp")
    if group is None:
        return attention_bthd(q, k, v, key_mask, sm_scale=sm_scale, use_kernel=use_kernel,
                              dropout_rate=dropout_rate, dropout_seed=dropout_seed,
                              head_keys=head_keys)
    sp = mesh.size("sp")
    if q.shape[2] % sp:
        raise ValueError(f"{q.shape[2]} heads do not split over sp={sp}")
    # [B, T/sp, H, D] → [B, T, H/sp, D]
    qh, kh, vh = (comm.all_to_all(x, group, 2, 1) for x in (q, k, v))
    full_mask = comm.gather_from_group(key_mask, group, 1)
    seed = dropout_seed
    if seed is not None and dropout_rate > 0.0:
        seed = to_int32(seed + mesh.index("sp") * SP_SEED_SALT)
    if head_keys is not None:
        head_keys = (head_keys[0] // sp, head_keys[1] // sp)
    ctx = attention_bthd(qh, kh, vh, full_mask, sm_scale=sm_scale, use_kernel=use_kernel,
                         dropout_rate=dropout_rate, dropout_seed=seed, head_keys=head_keys)
    return comm.all_to_all(ctx, group, 1, 2)  # back to [B, T/sp, H, D]
