"""Optimizers (counterpart of ``aat_tpu/training/optim.py``): the two
weight-decay groups and the freeze mask; ``fused_guarded_adamw``, the
trainer's optimizer whenever ``skip_nonfinite_updates`` is on (its
default); the unfused chain ``adamw_grouped`` with ``guard_nonfinite``;
``adafactor`` (optax's, under the JAX package's settings); and
``merge_matching_state``, which carries optimizer state across a rebuild
(the LM unfreeze).

Parameter trees are nested dicts and lists of tensors; a leaf's path is its
keys and list indices joined by "/" (``audio_encoder/layers/0/attention/q/
kernel``), the names the JAX rules read. A gradient of ``None`` (a layer
that LayerDrop skipped, or a frozen leaf) counts as zero, as the JAX
compute-then-select gives it. Optimizer states are NamedTuples of scalars
and such trees, with ``None`` where a leaf has no state (frozen leaves, and
the factored or unfactored slots Adafactor does not use); a state's path
takes the NamedTuple's field names (``inner_state/mu/adapter/...``).

Every transformation is ``GradientTransformation(init, update)``:
``update(grads, state, params)`` returns ``(updates, new_state)``, with
``None`` updates on frozen leaves, and runs on the device without a host
sync (the non-finite guards are tensor predicates).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """Map ``fn`` over the leaves of ``tree`` (dicts, lists and NamedTuples;
    ``None`` is a leaf) and of the trees of the same structure in
    ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_paths(tree, prefix: str = ""):
    """The same tree with each leaf replaced by its path string."""
    if isinstance(tree, dict):
        return {k: tree_paths(v, f"{prefix}{k}/") for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_paths(v, f"{prefix}{k}/") for k, v in zip(tree._fields, tree)))
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


def _pick(train, out, i):
    """The ``i``-th part of per-leaf result tuples, as a tree like ``train``."""
    return tree_map(lambda _, o: o[i], train, out)


def _schedule_at(learning_rate, count: torch.Tensor) -> torch.Tensor:
    """The step size at ``count``: a schedule's value, or the constant
    (``torch.full`` fills on the device; a ``torch.tensor`` of a Python
    float would copy from the host and wait for the device's queue)."""
    if callable(learning_rate):
        return learning_rate(count)
    return torch.full((), learning_rate, device=count.device)


def _bias_corrections(b1: float, b2: float, count_inc: torch.Tensor):
    """Adam's ``1 - b**count`` for both moments, in float32 on the device."""
    device = count_inc.device
    return (1.0 - torch.pow(torch.full((), b1, device=device), count_inc.float()),
            1.0 - torch.pow(torch.full((), b2, device=device), count_inc.float()))


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
                        freeze: Optional[dict] = None,
                        norm: Callable = global_norm) -> GradientTransformation:
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
    ``norm`` computes the global gradient norm (a mesh's over sharded
    leaves, :meth:`~aat_tpu_torch.parallel.mesh.Mesh.global_norm`).
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
        gn = norm(grads)
        ok = torch.isfinite(gn)
        one = torch.ones((), dtype=torch.float32, device=gn.device)
        scale = (torch.where(gn < clip_norm, one, clip_norm / gn)
                 if clip_norm is not None else one)
        count_inc = state.count + 1
        new_count = torch.where(ok, count_inc, state.count)
        lr_t = _schedule_at(learning_rate, state.count)
        bc1, bc2 = _bias_corrections(b1, b2, count_inc)

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

        out = tree_map(leaf, grads, state.mu, state.nu, params, decay, train)
        return _pick(train, out, 0), FusedGuardedAdamWState(
            new_count, _pick(train, out, 1), _pick(train, out, 2),
            state.total_notfinite + (1.0 - ok.float()))

    return GradientTransformation(init_fn, update_fn)


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # int32, steps taken (also the lr schedule's count)
    mu: dict             # first moments (None on frozen leaves)
    nu: dict             # second moments


def adamw_grouped(learning_rate, params, weight_decay: float = 0.1, b1: float = 0.9,
                  b2: float = 0.999, eps: float = 1e-8, grad_clip_norm: Optional[float] = None,
                  freeze: Optional[dict] = None,
                  norm: Callable = global_norm) -> GradientTransformation:
    """AdamW with the two weight-decay groups (``optim.py:73``): the optax
    chain ``clip_by_global_norm`` (with ``grad_clip_norm``) →
    ``scale_by_adam`` → ``add_decayed_weights(mask=decay_mask)`` →
    ``scale_by_learning_rate``, on the trainable leaves only (the JAX
    ``multi_transform`` freeze: frozen leaves get no update and no state,
    and the clip's norm leaves them out). The chain's Adam and schedule
    counts are always equal, so the state keeps one. ``norm`` computes the
    clip's global norm."""
    decay = decay_mask(params)
    train = freeze if freeze is not None else tree_map(lambda _: True, params)

    def init_fn(params):
        def zeros(p, t):
            return torch.zeros_like(p) if t else None

        device = tree_leaves(params)[0].device
        return ScaleByAdamState(torch.zeros((), dtype=torch.int32, device=device),
                                tree_map(zeros, params, train), tree_map(zeros, params, train))

    def update_fn(grads, state, params):
        grads = tree_map(lambda g, p, t: (torch.zeros_like(p) if g is None else g) if t else None,
                         grads, params, train)
        if grad_clip_norm is not None:
            gn = norm(grads)
            below = gn < grad_clip_norm
            grads = tree_map(lambda g: None if g is None else torch.where(
                below, g, (g / gn.to(g.dtype)) * grad_clip_norm), grads)
        count_inc = state.count + 1
        lr_t = _schedule_at(learning_rate, state.count)
        bc1, bc2 = _bias_corrections(b1, b2, count_inc)

        def leaf(g, m, v, p, d):
            if g is None:
                return None, None, None
            m = (1.0 - b1) * g + b1 * m
            v = (1.0 - b2) * (g * g) + b2 * v
            u = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if d:
                u = u + weight_decay * p
            return (-lr_t).to(g.dtype) * u, m, v

        out = tree_map(leaf, grads, state.mu, state.nu, params, decay)
        return _pick(train, out, 0), ScaleByAdamState(count_inc, _pick(train, out, 1),
                                                      _pick(train, out, 2))

    return GradientTransformation(init_fn, update_fn)


class GuardNonfiniteState(NamedTuple):
    total_notfinite: torch.Tensor  # float32 count of dropped steps
    inner_state: object


def guard_nonfinite(inner: GradientTransformation, clip_norm: Optional[float] = None,
                    norm: Callable = global_norm) -> GradientTransformation:
    """The non-finite guard (``optim.py:150``) around ``inner``: where the
    global gradient norm is not finite the update is zero, ``inner``'s
    state stays as it was and ``total_notfinite`` counts the step. With
    ``clip_norm`` the global-norm clip (``clip_by_global_norm``'s factor,
    1 below the norm, else clip / norm) folds into the same norm, applied
    before ``inner``. ``norm`` computes the global norm."""

    def init_fn(params):
        device = tree_leaves(params)[0].device
        return GuardNonfiniteState(torch.zeros((), dtype=torch.float32, device=device),
                                   inner.init(params))

    def update_fn(grads, state, params):
        gn = norm(grads)
        ok = torch.isfinite(gn)
        one = torch.ones((), dtype=torch.float32, device=gn.device)
        scale = (torch.where(gn < clip_norm, one, clip_norm / gn)
                 if clip_norm is not None else one)
        safe = tree_map(lambda g: None if g is None else torch.where(
            ok, g * scale.to(g.dtype), 0.0), grads)
        updates, new_inner = inner.update(safe, state.inner_state, params)
        updates = tree_map(lambda u: None if u is None else torch.where(ok, u, 0.0), updates)
        new_inner = tree_map(lambda n, o: None if n is None else torch.where(ok, n, o),
                             new_inner, state.inner_state)
        return updates, GuardNonfiniteState(state.total_notfinite + (1.0 - ok.float()),
                                            new_inner)

    return GradientTransformation(init_fn, update_fn)


class FactoredState(NamedTuple):
    count: torch.Tensor  # int32, steps taken (also the step-size schedule's count)
    v_row: dict          # factored second moments (None on 1-D and frozen leaves)
    v_col: dict
    v: dict              # unfactored second moments (1-D leaves only)


def factored_dims(shape) -> Optional[tuple]:
    """``(d1, d0)``, the second-largest and largest axes (optax's
    ``_factored_dims`` with ``min_dim_size_to_factor=0``: every leaf of two
    or more dimensions is factored), or None for a 1-D leaf."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape, kind="stable")
    return int(order[-2]), int(order[-1])


def relative_step(count: torch.Tensor) -> torch.Tensor:
    """Adafactor's relative step size ``min(1e-2, rsqrt(count + 1))``."""
    return torch.clamp_max(torch.rsqrt(count.float() + 1.0), 1e-2)


def adafactor(learning_rate=None, weight_decay: float = 0.0, freeze: Optional[dict] = None,
              axes: Optional[dict] = None) -> GradientTransformation:
    """``optax.adafactor`` under the JAX package's settings (``optim.py:101``),
    op for op in optax 0.2.6's order, per trainable leaf:

    1. ``scale_by_factored_rms``: ``g² + 1e-30`` decayed into the second
       moments at ``1 - (count + 1)^-0.8``; a leaf of two or more dimensions
       keeps its means over the largest axis (``v_row``) and the second
       largest (``v_col``) and scales by ``(v_row / mean(v_row))^-½`` and
       ``v_col^-½``; a 1-D leaf keeps ``v`` and scales by ``v^-½``;
    2. ``clip_by_block_rms(1.0)``: divide by ``max(1, rms(u))``;
    3. the step size at ``count``: ``learning_rate`` (a schedule or a
       constant), or the relative step :func:`relative_step` when it is
       None, which also
    4. multiplies by the parameter's RMS, floored at 1e-3;
    5. ``+ weight_decay · p`` when ``weight_decay`` (unscaled by the step
       size: optax's behaviour, which the JAX docstring records as a known
       deviation from fairseq);
    6. the sign flip.

    Frozen leaves (``freeze`` False) get no update and no state. ``axes``
    maps a leaf's path to the ``(d1, d0)`` it factors over instead of
    :func:`factored_dims` of its shape (the conv kernels, whose port layout
    permutes JAX's axes: ``utils.port.adafactor_axes``)."""
    relative = learning_rate is None
    axes = axes or {}

    def dims_of(path, p):
        return axes[path] if path in axes else factored_dims(p.shape)

    if relative:
        learning_rate = relative_step
    decay_exponent, eps, clip, min_rms = 0.8, 1e-30, 1.0, 1e-3

    def init_fn(params):
        train = freeze if freeze is not None else tree_map(lambda _: True, params)

        def slots(p, t, path):
            if not t:
                return None, None, None
            dims = dims_of(path, p)
            if dims is None:
                return None, None, torch.zeros_like(p)
            d1, d0 = dims
            shape = list(p.shape)
            row = shape[:d0] + shape[d0 + 1:]
            col = shape[:d1] + shape[d1 + 1:]
            return p.new_zeros(row), p.new_zeros(col), None

        out = tree_map(slots, params, train, tree_paths(params))
        device = tree_leaves(params)[0].device
        return FactoredState(torch.zeros((), dtype=torch.int32, device=device),
                             _pick(train, out, 0), _pick(train, out, 1), _pick(train, out, 2))

    def update_fn(grads, state, params):
        train = freeze if freeze is not None else tree_map(lambda _: True, params)
        decay = 1.0 - torch.pow((state.count + 1).float(), -decay_exponent)
        lr_t = _schedule_at(learning_rate, state.count)

        def leaf(g, v_row, v_col, v, p, t, path):
            if not t:
                return None, None, None, None
            if g is None:
                g = torch.zeros_like(p)
            g_sq = g * g + eps
            dims = dims_of(path, p)
            if dims is not None:
                d1, d0 = dims
                v_row = decay * v_row + (1.0 - decay) * g_sq.mean(d0)
                v_col = decay * v_col + (1.0 - decay) * g_sq.mean(d1)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_factor = (v_row / v_row.mean(reduced_d1, keepdim=True)) ** -0.5
                u = g * row_factor.unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
            else:
                v = decay * v + (1.0 - decay) * g_sq
                u = g * v ** -0.5
            u = u / torch.clamp_min(torch.sqrt(torch.mean(u * u)) / clip, 1.0)
            u = lr_t.to(u.dtype) * u
            if relative:
                rms = torch.sqrt(torch.mean(p * p))
                u = u * torch.where(rms <= min_rms, min_rms, rms)
            if weight_decay:
                u = u + weight_decay * p
            return -1.0 * u, v_row, v_col, v

        out = tree_map(leaf, grads, state.v_row, state.v_col, state.v, params, train,
                       tree_paths(params))
        return _pick(train, out, 0), FactoredState(
            state.count + 1, _pick(train, out, 1), _pick(train, out, 2), _pick(train, out, 3))

    return GradientTransformation(init_fn, update_fn)


def merge_matching_state(old_state, new_state):
    """``new_state`` with every leaf whose path, shape and dtype match a
    leaf of ``old_state`` taken from ``old_state`` (``optim.py:330``): on a
    rebuild (the LM unfreeze) the subtrees that trained keep their moments,
    the newly trainable leaves start fresh, and scalars such as the step
    count carry over (JAX's deliberate simplification: the new group's bias
    correction starts at the current step)."""
    old = {path: leaf for path, leaf in zip(tree_leaves(tree_paths(old_state)),
                                            tree_leaves(old_state))}

    def pick(path, new):
        prev = old.get(path)
        if (torch.is_tensor(prev) and torch.is_tensor(new) and prev.shape == new.shape
                and prev.dtype == new.dtype):
            return prev
        return new

    return tree_map(pick, tree_paths(new_state), new_state)


def apply_updates(params, updates) -> None:
    """``params += updates`` in place (``optax.apply_updates``); frozen
    leaves (update ``None``) stay untouched, bit for bit."""
    with torch.no_grad():
        tree_map(lambda p, u: p.add_(u) if u is not None else None, params, updates)
