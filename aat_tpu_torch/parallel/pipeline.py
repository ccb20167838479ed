"""Pipeline parallelism: a GPipe schedule over stacked layers (counterpart
of ``aat_tpu/parallel/pipeline.py``), over the mesh's ``pp`` process
groups.

* The pipelined stacks (HuBERT's encoder layers, the LM's decoder layers)
  switch to the *stacked* layout under ``pp > 1``: their per-layer list
  becomes one tree of ``[L, ...]`` leaves (:func:`stack_model_layers`),
  whose leading dim is sharded over ``pp`` (:func:`stacked_leaf_spec`).
  Stage ``s`` holds layers ``[s·L/pp, (s+1)·L/pp)``, and so do its
  gradients and optimizer moments.
* :func:`gpipe_apply` splits this rank's rows into M microbatches. At tick
  ``t`` stage ``s`` runs its layers on microbatch ``clip(t − s, 0, M−1)``
  and passes the result to stage ``s+1`` (:func:`~aat_tpu_torch.parallel.
  comm.ring_permute`); ``M + pp − 1`` ticks drain the pipe. Every stage
  computes on every tick, as JAX's SPMD schedule does (the bubble ticks
  compute on inputs no result keeps), so every rank of a pp group issues
  the same ring steps in the same order, forward and backward. The
  bubble share is ``(pp − 1) / (M + pp − 1)``.
* Autograd differentiates the schedule: the ring permute's gradient is the
  reverse ring. The input enters through ``copy_to_group`` over pp
  (identity forward, sum backward: only stage 0 reads it) and the result
  leaves through ``reduce_from_group`` of the last stage's output, zeros
  elsewhere (JAX's zero-and-``psum``, identity backward), so every pp
  peer holds the same gradient for each parameter outside the stacks.

fsdp inside the pipeline: a stacked leaf's fsdp shard is gathered once a
step where the trainer's ``Mesh.use_params`` builds the forward's tree, and
its gradient reduce-scattered back by that gather's backward. tp inside
it: where the models' ``tp_partitionable`` holds, stacked leaves are also
tp-sharded (Megatron roles) and the stage bodies are the models'
tensor-parallel bodies.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from aat_tpu_torch.parallel import comm
from aat_tpu_torch.training.optim import tree_leaves, tree_map, tree_paths

# the JAX rules' module roles (``stacked_leaf_spec``)
_COLUMN = ("/q/", "/k/", "/v/", "/gate/", "/up/", "/intermediate/")
_ROW = ("/out/", "/down/", "/output/")


def stack_layers(layers: Sequence):
    """Per-layer trees → one tree of ``[L, ...]`` leaves."""
    return tree_map(lambda *xs: torch.stack(xs), layers[0], *layers[1:])


def is_stacked(layers) -> bool:
    """True for the stacked layout (one tree of ``[L, ...]`` leaves), False
    for the interchange layout (a list of per-layer trees)."""
    return isinstance(layers, dict)


def layer_seq(layers, num_layers: int) -> list:
    """``layers`` as a per-layer sequence in either layout (stacked leaves
    are viewed, not copied)."""
    if not is_stacked(layers):
        return list(layers)
    return [tree_map(lambda x, i=i: x[i], layers) for i in range(num_layers)]


def stack_model_layers(params: dict) -> dict:
    """A model subtree with its ``layers`` list replaced by the stacked tree."""
    if isinstance(params.get("layers"), (list, tuple)):
        params = dict(params)
        params["layers"] = stack_layers(params["layers"])
    return params


def unstack_model_layers(params: dict) -> dict:
    """Inverse of :func:`stack_model_layers` (the interchange layout of
    exports and one-process runs)."""
    if is_stacked(params.get("layers")):
        params = dict(params)
        stacked = params["layers"]
        params["layers"] = layer_seq(stacked, int(tree_leaves(stacked)[0].shape[0]))
    return params


def check_layers(num_layers: int, pp: int) -> int:
    """Layers a stage (``num_layers / pp``); raises unless ``pp`` divides
    ``num_layers`` (JAX asserts it)."""
    if num_layers % pp:
        raise ValueError(f"num_hidden_layers={num_layers} is not divisible by mesh_pp={pp}")
    return num_layers // pp


def stacked_leaf_spec(name: str, shape, tp: int = 1, fsdp: int = 1) -> tuple:
    """The spec of one stacked leaf ``[L, ...]`` (JAX's ``stacked_leaf_spec``):
    the layer dim on ``pp``; with ``tp > 1`` column-parallel q/k/v/gate/up/
    intermediate leaves split their last dim (biases follow their columns)
    and row-parallel out/down/output kernels their input dim; with ``fsdp >
    1`` leaves of 3 or more dims split their widest still-free non-layer
    axis. Stacked biases and norm scales stay fsdp-replicated. ``name`` is
    the leaf's path with "/" around every key."""
    rest = [None] * (len(shape) - 1)
    if tp > 1 and rest:
        if any(k in name for k in _COLUMN) and shape[-1] % tp == 0:
            rest[-1] = "tp"
        elif any(k in name for k in _ROW) and len(shape) >= 3 and shape[1] % tp == 0:
            rest[0] = "tp"
    if fsdp > 1 and len(shape) >= 3:
        for i in sorted(range(1, len(shape)), key=lambda i: -shape[i]):
            if rest[i - 1] is None and shape[i] % fsdp == 0 and shape[i] >= fsdp:
                rest[i - 1] = "fsdp"
                break
    return ("pp", *rest)


def stacked_layer_specs(stacked, tp: int = 1, fsdp: int = 1) -> dict:
    """:func:`stacked_leaf_spec` of every leaf of a stacked layer tree, by
    its path in the tree (the roles read from those paths, as JAX's)."""
    return {path: stacked_leaf_spec(f"/{path}/", tuple(leaf.shape), tp, fsdp)
            for path, leaf in zip(tree_leaves(tree_paths(stacked)), tree_leaves(stacked))}


def microbatch_count(requested: int, rows: int) -> int:
    """JAX's clamp: the largest count at most ``requested`` (and ``rows``)
    that divides this rank's ``rows``."""
    m = max(1, min(requested, rows))
    while rows % m:
        m -= 1
    return m


def _enter(x: torch.Tensor, group) -> torch.Tensor:
    # identity forward; the backward sums the stages' gradients (stage 0's)
    return comm.copy_to_group(x, group)


def _exit(y: torch.Tensor, group) -> torch.Tensor:
    # the last stage's result on every stage; each keeps its own gradient
    return comm.reduce_from_group(y, group)


def gpipe_apply(layer_fn: Callable, stacked, x: torch.Tensor, batched: tuple, mesh, *,
                num_layers: int, microbatches: int = 0) -> torch.Tensor:
    """Run ``x`` (this rank's rows) through ``num_layers`` stacked layers,
    pipelined over ``mesh``'s pp axis (at least 2 stages); ``stacked`` is
    this stage's slice (``[L/pp, ...]`` leaves).

    ``layer_fn(h, layer, global_layer_index, shard, *batched_mb) -> h``
    applies one layer; ``shard`` is the microbatch's
    :class:`~aat_tpu_torch.ops.dropout.ElementShard` (its rows' place in
    the global batch, for the dropout masks), and ``batched`` holds
    ``[rows, ...]`` tensors that follow the microbatch split (a frame mask).
    ``microbatches`` (0: ``2·pp``) is clamped as JAX clamps it
    (:func:`microbatch_count`)."""
    pp = mesh.size("pp")
    per_stage = check_layers(num_layers, pp)
    stage, group = mesh.coords["pp"], mesh.group("pp")
    rows = x.shape[0]
    m = microbatch_count(microbatches or 2 * pp, rows)
    xs = _enter(x, group).reshape(m, rows // m, *x.shape[1:])
    bcs = [c.reshape(m, rows // m, *c.shape[1:]) for c in batched]
    layers = layer_seq(stacked, per_stage)
    shards = [mesh.element_shard()._replace(row_block=mesh.data_rank * m + j) for j in range(m)]
    first = torch.full((), stage == 0, dtype=torch.bool, device=x.device)
    last = torch.full((), stage == pp - 1, dtype=torch.bool, device=x.device)
    act = torch.zeros_like(xs[0])
    outs = []
    ticks = m + pp - 1
    for t in range(ticks):
        j = min(max(t - stage, 0), m - 1)  # this stage's microbatch
        # stage 0 takes the input; the where keeps the received activation
        # in the graph, so its (zero) gradient still goes round the ring
        h = torch.where(first, xs[min(t, m - 1)], act)
        for i, layer in enumerate(layers):
            h = layer_fn(h, layer, stage * per_stage + i, shards[j], *(c[j] for c in bcs))
        if t >= pp - 1:  # the last stage emits microbatch t - (pp - 1)
            outs.append(h)
        if t < ticks - 1:
            act = comm.ring_permute(h, group)
    y = torch.cat(outs)
    return _exit(torch.where(last, y, torch.zeros_like(y)), group)


def flat_to_layout(flat: dict, params: dict) -> dict:
    """A checkpoint's flat ``{dotted path: tensor}`` params in the layout of
    ``params``: the per-layer entries of a subtree (``lm_decoder.layers.3.
    mlp.up.kernel``) stacked where ``params`` holds its layers stacked, and
    stacked entries (``lm_decoder.layers.mlp.up.kernel``) cut into fresh
    per-layer tensors where it holds a list. Other entries pass as they
    are."""
    out = dict(flat)
    for key, sub in params.items():
        if not (isinstance(sub, dict) and "layers" in sub):
            continue
        prefix = f"{key}.layers."
        mine = {k[len(prefix):]: k for k in flat if k.startswith(prefix)}
        per_layer = {rest: k for rest, k in mine.items() if rest.split(".", 1)[0].isdigit()}
        if is_stacked(sub["layers"]) and per_layer:
            by_leaf: dict = {}
            for rest, k in per_layer.items():
                i, leaf = rest.split(".", 1)
                by_leaf.setdefault(leaf, {})[int(i)] = out.pop(k)
            for leaf, layers in by_leaf.items():
                out[prefix + leaf] = torch.stack([layers[i] for i in sorted(layers)])
        elif not is_stacked(sub["layers"]) and len(per_layer) < len(mine):
            for rest, k in mine.items():
                if rest not in per_layer:
                    for i, x in enumerate(out.pop(k).unbind(0)):
                        out[f"{prefix}{i}.{rest}"] = x.clone()
    return out
