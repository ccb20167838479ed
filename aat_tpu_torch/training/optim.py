"""Optimizer (counterpart of ``aat_tpu/training/optim.py``): the two
weight-decay groups, the freeze mask, and ``fused_guarded_adamw`` — the
JAX trainer's optimizer whenever ``skip_nonfinite_updates`` is on (its
default).

Parameter trees are nested dicts and lists of tensors; a leaf's path is its
keys and list indices joined by "/" (``audio_encoder/layers/0/attention/q/
kernel``), the names the JAX rules read. A gradient of ``None`` (a layer
that LayerDrop skipped) counts as zero, as the JAX compute-then-select
gives it.

Not ported yet (ROADMAP Queue 1, trainer pieces): ``adafactor`` and the
unfused ``adamw_grouped`` / ``guard_nonfinite`` chain.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import torch


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of ``tree`` (dicts and lists) and of the
    trees of the same structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_paths(tree, prefix: str = ""):
    """The same tree with each leaf replaced by its path string."""
    if isinstance(tree, dict):
        return {k: tree_paths(v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_paths(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return prefix[:-1]


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def decay_mask(params) -> dict:
    """True where weight decay applies: ndim >= 2 kernels/embeddings, except
    norm scales and biases (path contains "bias", "norm" or "scale")."""

    def is_decay(path, leaf):
        name = path.lower()
        if "bias" in name or "norm" in name or "scale" in name:
            return False
        return leaf.ndim >= 2

    return tree_map(is_decay, tree_paths(params), params)


def trainable_mask(params, train_audio_encoder: bool = True, train_lm_decoder: bool = False,
                   frozen_prefixes: Sequence[str] = ()) -> dict:
    """Freeze mask over the ASLM tree {audio_encoder, adapter, lm_decoder}."""

    def is_trainable(path):
        if path.startswith("audio_encoder") and not train_audio_encoder:
            return False
        if path.startswith("lm_decoder") and not train_lm_decoder:
            return False
        return not any(path.startswith(p) for p in frozen_prefixes)

    return tree_map(is_trainable, tree_paths(params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf (``optax.global_norm``),
    as a float32 tensor; ``None`` leaves count as zero."""
    leaves = [x for x in tree_leaves(tree) if x is not None]
    total = sum((x.float() * x.float()).sum() for x in leaves)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def adamw_grouped(*args, **kwargs):
    raise NotImplementedError(
        "the unfused AdamW chain is not ported yet (ROADMAP Queue 1, trainer pieces); "
        "fused_guarded_adamw is the trainer's default")


def guard_nonfinite(*args, **kwargs):
    raise NotImplementedError(
        "the unfused guard chain is not ported yet (ROADMAP Queue 1, trainer pieces); "
        "fused_guarded_adamw folds the guard in")


def adafactor(*args, **kwargs):
    raise NotImplementedError("adafactor is not ported yet (ROADMAP Queue 1, trainer pieces)")


class FusedGuardedAdamWState(NamedTuple):
    count: torch.Tensor            # int32, number of APPLIED (finite) steps
    mu: dict                       # first moments (None on frozen leaves)
    nu: dict                       # second moments
    total_notfinite: torch.Tensor  # float32 count of dropped steps


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def fused_guarded_adamw(learning_rate, params, weight_decay: float = 0.1, b1: float = 0.9,
                        b2: float = 0.999, eps: float = 1e-8,
                        clip_norm: Optional[float] = None,
                        freeze: Optional[dict] = None) -> GradientTransformation:
    """AdamW with the non-finite guard and global-norm clip folded in
    (``optim.py:216``), value for value:

    * moments ``mu' = (1-b1)·g + b1·mu`` with ``g = where(ok, clip·grad, 0)``;
    * bias correction ``1 - b**(count+1)`` in float32; the learning rate
      evaluated at the pre-increment ``count``;
    * weight decay ``+ wd·p`` on the decay group, before the lr scale;
    * a dropped step (non-finite global grad norm): zero update, moments and
      count unchanged, ``total_notfinite`` bumped;
    * frozen leaves: zero update and no state (``None``).

    Everything stays on the device: the guard is a tensor predicate, so a
    step never waits for the host. ``update(grads, state, params)`` returns
    ``(updates, new_state)``; updates of frozen leaves are ``None``.
    """
    decay = decay_mask(params)
    train = freeze if freeze is not None else tree_map(lambda _: True, params)

    def init_fn(params):
        def zeros(p, t):
            return torch.zeros_like(p) if t else None

        device = tree_leaves(params)[0].device
        return FusedGuardedAdamWState(
            torch.zeros((), dtype=torch.int32, device=device),
            tree_map(zeros, params, train), tree_map(zeros, params, train),
            torch.zeros((), dtype=torch.float32, device=device))

    def update_fn(grads, state, params):
        gn = global_norm(grads)
        ok = torch.isfinite(gn)
        one = torch.ones((), dtype=torch.float32, device=gn.device)
        scale = (torch.where(gn < clip_norm, one, clip_norm / gn)
                 if clip_norm is not None else one)
        count_inc = state.count + 1
        new_count = torch.where(ok, count_inc, state.count)
        lr_t = (learning_rate(state.count) if callable(learning_rate)
                else torch.full((), learning_rate, device=gn.device))
        # torch.full fills on the device; a torch.tensor of a Python float
        # would copy from the host and wait for the device's queue
        bc1 = 1.0 - torch.pow(torch.full((), b1, device=gn.device), count_inc.float())
        bc2 = 1.0 - torch.pow(torch.full((), b2, device=gn.device), count_inc.float())

        def leaf(g, m, v, p, d, t):
            if not t:
                return None, None, None
            if g is None:
                g = torch.zeros_like(p)
            gs = torch.where(ok, g * scale.to(g.dtype), 0.0)
            m_ok = (1.0 - b1) * gs + b1 * m
            v_ok = (1.0 - b2) * (gs * gs) + b2 * v
            direction = (m_ok / bc1) / (torch.sqrt(v_ok / bc2) + eps)
            if d:
                direction = direction + weight_decay * p
            upd = (-lr_t).to(g.dtype) * direction
            return (torch.where(ok, upd, 0.0), torch.where(ok, m_ok, m),
                    torch.where(ok, v_ok, v))

        out = tree_map(lambda *a: leaf(*a), grads, state.mu, state.nu, params, decay, train)
        pick = lambda i: tree_map(lambda _, o: o[i], train, out)  # noqa: E731
        return pick(0), FusedGuardedAdamWState(
            new_count, pick(1), pick(2), state.total_notfinite + (1.0 - ok.float()))

    return GradientTransformation(init_fn, update_fn)


def apply_updates(params, updates) -> None:
    """``params += updates`` in place (``optax.apply_updates``); frozen
    leaves (update ``None``) stay untouched, bit for bit."""
    with torch.no_grad():
        tree_map(lambda p, u: p.add_(u) if u is not None else None, params, updates)
