"""Nearest-codebook quantization of segment embeddings (counterpart of
``aat_tpu/ops/vq.py``).

:func:`nearest_codebook` is the assignment step: for each row of x
``[N, D]`` the code of ``codebook [K, D]`` with the least
``‖c‖² − 2·x·c`` (``‖x‖²`` is argmin-invariant and dropped), ties going to
the lowest code id, then the row gather ``codebook[idx]``. On a CUDA tensor
it launches the hand-written kernel ``csrc/vq.cu``
(:func:`nearest_codebook_kernel`, the counterpart of the TPU kernel
``aat_tpu/ops/vq.py:50`` ``_make_vq_kernel`` that
``nearest_codebook_pallas`` launches); on a CPU tensor it takes the plain
version (:func:`nearest_codebook_reference`: one f32 GEMM and
``torch.argmin``, whose first minimum is the lowest id). The code norms
and the gather stay outside the kernel, so both routes read the same
``cbn`` tensor. This one function stands in for both JAX names,
``nearest_codebook`` and ``nearest_codebook_pallas``.

Near-ties: the kernel and a library GEMM sum ``x·c`` in other orders, so
two codes whose distances differ by a few ulps may resolve differently
between the routes. Exact ties (duplicate codes) always go to the lowest id.

:func:`vq_forward` is the straight-through VQ; :func:`vq_ema_update` the EMA
k-means step, with the same deterministic one-hot product as JAX (no
atomics, so a k-means trajectory repeats run to run).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from aat_tpu_torch.models.hubert import np_rng_from


def codebook_norms(codebook: torch.Tensor) -> torch.Tensor:
    """``‖c‖²`` per code, ``[K]`` f32."""
    return (codebook.to(torch.float32) ** 2).sum(-1)


def nearest_codebook_reference(x: torch.Tensor, codebook: torch.Tensor,
                               cbn: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: ``argmin(cbn − 2·x@cᵀ)`` → ``[N]``
    int32. On a CUDA tensor the caller must have TF32 matmuls off (PyTorch's
    default), or near-ties flip."""
    scores = torch.matmul(x.to(torch.float32), codebook.to(torch.float32).t())
    return torch.argmin(cbn[None, :] - 2.0 * scores, dim=-1).to(torch.int32)


def nearest_codebook_kernel(x: torch.Tensor, codebook: torch.Tensor,
                            cbn: torch.Tensor) -> torch.Tensor:
    """Launch ``aat_vq_nearest`` (replaces the TPU kernel
    aat_tpu/ops/vq.py:50 ``_make_vq_kernel``) on CUDA tensors → ``[N]``
    int32 code ids."""
    from aat_tpu_torch.runtime.kernels import library, stream_handle

    if x.device.type != "cuda":
        raise ValueError(f"vq kernel needs CUDA tensors, got {x.device}")
    if x.ndim != 2 or codebook.ndim != 2 or x.shape[1] != codebook.shape[1]:
        raise ValueError(f"shapes x {tuple(x.shape)} codebook {tuple(codebook.shape)}")
    n, d = x.shape
    k = codebook.shape[0]
    if cbn.shape != (k,):
        raise ValueError(f"cbn {tuple(cbn.shape)} does not fit {k} codes")
    for name, t in (("x", x), ("codebook", codebook), ("cbn", cbn)):
        if t.dtype != torch.float32 or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous f32 on {x.device}")
    idx = torch.empty((n,), dtype=torch.int32, device=x.device)
    library().call("aat_vq_nearest", x.data_ptr(), codebook.data_ptr(), cbn.data_ptr(),
                   idx.data_ptr(), n, k, d, stream_handle(x.device))
    nearest_codebook_kernel.launches += 1
    return idx


nearest_codebook_kernel.launches = 0


def nearest_codebook(x: torch.Tensor, codebook: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ ``(indices [N] int32, codebook[indices] [N, D])``. The gather keeps
    the codebook's gradient (``jax.grad`` through ``codebook[indices]``)."""
    with torch.no_grad():
        cb = codebook.detach().to(torch.float32).contiguous()
        xs = x.detach().to(torch.float32).contiguous()
        cbn = codebook_norms(cb)
        if xs.device.type == "cpu":
            idx = nearest_codebook_reference(xs, cb, cbn)
        else:
            idx = nearest_codebook_kernel(xs, cb, cbn)
    return idx, codebook[idx.long()]


class VQState(NamedTuple):
    codebook: torch.Tensor  # [K, D]
    ema_counts: torch.Tensor  # [K]
    ema_sums: torch.Tensor  # [K, D]


def init_vq_state(seed, num_codes: int, dim: int, device=None) -> VQState:
    """Standard-normal codebook drawn as the JAX package draws it: ``seed``
    is an int or a JAX PRNG key's data words (``(0, 0)`` for
    ``PRNGKey(0)``)."""
    codebook = torch.from_numpy(
        np_rng_from(seed).normal(0, 1.0, (num_codes, dim)).astype("float32")).to(device)
    return VQState(codebook, torch.ones((num_codes,), dtype=torch.float32, device=device),
                   codebook.clone())


def vq_forward(state: VQState, embeddings: torch.Tensor, beta: float = 0.25):
    """Straight-through VQ → ``(quantized_st, indices, loss)``: the loss is
    the codebook term plus ``beta`` times the commitment term; gradients
    reach both the embeddings and the codebook."""
    indices, quantized = nearest_codebook(embeddings, state.codebook)
    commit = ((embeddings - quantized.detach()) ** 2).sum(-1).mean()
    codebook_loss = ((embeddings.detach() - quantized) ** 2).sum(-1).mean()
    loss = codebook_loss + beta * commit
    quantized_st = embeddings + (quantized - embeddings).detach()
    return quantized_st, indices, loss


def vq_ema_update(state: VQState, embeddings: torch.Tensor, indices: torch.Tensor,
                  decay: float = 0.99) -> VQState:
    """EMA k-means step: per-code counts and sums through a one-hot
    product, decayed into the state; codes are sums over counts floored at
    1e-5."""
    k = state.codebook.shape[0]
    one_hot = F.one_hot(indices.long(), k).to(torch.float32)  # [N, K]
    counts = one_hot.sum(0)
    sums = torch.matmul(one_hot.t(), embeddings.to(torch.float32))
    new_counts = decay * state.ema_counts + (1 - decay) * counts
    new_sums = decay * state.ema_sums + (1 - decay) * sums
    new_codebook = new_sums / torch.clamp_min(new_counts, 1e-5)[:, None]
    return VQState(new_codebook, new_counts, new_sums)
