"""Device mesh and sharding rules (counterpart of
``aat_tpu/parallel/mesh.py``) over ``torch.distributed`` process groups.

One process per device. Rank r sits at ``np.unravel_index(r, (dp, fsdp,
tp, sp, pp))``, JAX's row-major device order, and every set of axes has a
process group: the ranks that share the coordinates of the other axes,
in rank order. The pipeline axis is ROADMAP Queue 1 item 8b.

Parameters are *stored* as the JAX package's ``_spec_for`` shards them
(:func:`spec_for`, :func:`shard_params`, :func:`place_params`), so each
rank keeps 1/fsdp (and 1/tp) of a sharded leaf and of its optimizer
moments. At *use* (:meth:`Mesh.use_params`) a tp-sharded leaf inside a
tensor-parallel body (the models' layers, where their ``tp_partitionable``
holds) stays its shard, and every other sharded leaf is all-gathered:
over fsdp with a reduce-scatter gradient (the fsdp ranks see other
rows), over tp with the rank's own chunk of the gradient (tp peers
compute the same loss). So results equal GSPMD's without a
vocab-parallel cross-entropy. After the backward, :meth:`Mesh.reduce_grads`
sums each leaf's gradient over the ranks that computed distinct parts of
it: dp, fsdp where the leaf is not fsdp-sharded, and sp for the leaves
of the time-sharded encoder stack.

A :class:`Spec` has one entry per dimension: ``None``, an axis name, or a
tuple of names (the vocab axis of an embedding under tp and fsdp, split
tp-major).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from aat_tpu_torch.ops.dropout import ElementShard
from aat_tpu_torch.parallel import comm
from aat_tpu_torch.training.optim import tree_leaves, tree_map, tree_paths
from aat_tpu_torch.utils import port

AXES = ("dp", "fsdp", "tp", "sp", "pp")
PIPELINE_ITEM = "ROADMAP Queue 1 item 8b"

# the JAX rules' module names (``mesh.py:_spec_for``)
COLUMN_PARALLEL = ("/q/", "/k/", "/v/", "/gate/", "/up/", "/intermediate/", "/in_proj/",
                   "/l_in/", "/in/")
ROW_PARALLEL = ("/out/", "/down/", "/output/", "/out_proj/", "/l_out/")


def _axes_of(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Spec:
    """A leaf's sharding: one entry per dimension (a leaf of the trees of
    :mod:`~aat_tpu_torch.training.optim`, where a tuple would be a node)."""

    dims: tuple

    def axes(self) -> set:
        return {a for e in self.dims for a in _axes_of(e)}


def spec_for(path: str, shape: Sequence[int], sizes: Dict[str, int]) -> tuple:
    """The JAX package's ``_spec_for`` on a JAX-layout shape: ``path`` is
    its ``"//a//b//kernel/"`` form (:func:`jax_path`)."""
    tp, fsdp = sizes.get("tp", 1), sizes.get("fsdp", 1)
    ndim = len(shape)
    spec = [None] * ndim
    if tp > 1 and ndim >= 2:
        if any(k in path for k in COLUMN_PARALLEL):
            if shape[-1] % tp == 0:
                spec[-1] = "tp"
        elif any(k in path for k in ROW_PARALLEL):
            if shape[-2] % tp == 0:
                spec[-2] = "tp"
        elif "embedding" in path and shape[0] % tp == 0:
            spec[0] = "tp"
    if fsdp > 1 and ndim >= 2:
        if "embedding" in path:
            # vocab-parallel embeddings extend fsdp along the vocab axis
            if spec[0] == "tp":
                if shape[0] % (tp * fsdp) == 0:
                    spec[0] = ("tp", "fsdp")
            elif shape[0] % fsdp == 0:
                spec[0] = "fsdp"
            return tuple(spec)
        # ZeRO-3: the largest still-unsharded axis divisible by fsdp; 1-D
        # leaves stay replicated
        for i in sorted(range(ndim), key=lambda i: -shape[i]):
            if spec[i] is None and shape[i] % fsdp == 0 and shape[i] >= fsdp:
                spec[i] = "fsdp"
                break
    return tuple(spec)


def jax_path(keys: Iterable) -> str:
    """The path string JAX's ``shard_params`` walk builds for a leaf."""
    return "/" + "".join(f"/{k}/" for k in keys)


def shard_params(params, sizes: Dict[str, int]):
    """The spec of every leaf of a port parameter tree (anything with a
    ``shape``), in the port's layout: a conv kernel's spec is JAX's for its
    JAX-layout shape, carried through its axis permutation
    (:func:`aat_tpu_torch.utils.port.encoder_conv_perms`)."""
    perms = {"/".join(map(str, p)): perm for p, perm in port.conv_perms(params).items()}

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        perm = perms.get(path)
        keys = path.split("/")
        if perm is None:
            return Spec(spec_for(jax_path(keys), shape, sizes))
        jax_shape = tuple(shape[perm.index(j)] for j in range(len(shape)))
        jax_spec = spec_for(jax_path(keys), jax_shape, sizes)
        return Spec(tuple(jax_spec[perm[i]] for i in range(len(shape))))

    return tree_map(spec, tree_paths(params), params)


class Mesh:
    """The (dp, fsdp, tp, sp, pp) layout of an initialized process group,
    with a group for every set of axes. :func:`make_mesh` builds it."""

    def __init__(self, sizes: Dict[str, int], rank: int, world_size: int):
        self.shape = {a: int(sizes.get(a, 1)) for a in AXES}
        dims = tuple(self.shape[a] for a in AXES)
        self.rank = rank
        self.coords = dict(zip(AXES, (int(i) for i in np.unravel_index(rank, dims))))
        self._groups = {}
        grid = np.arange(world_size).reshape(dims)
        created = {}
        # every rank creates every group, in one order (new_group's rule)
        for n in range(1, len(AXES) + 1):
            for axes in itertools.combinations(AXES, n):
                keep = [AXES.index(a) for a in axes]
                other = [i for i in range(len(AXES)) if i not in keep]
                blocks = np.moveaxis(grid, other + keep, range(len(AXES)))
                blocks = blocks.reshape(-1, int(np.prod([dims[i] for i in keep])))
                for block in blocks:
                    members = tuple(int(r) for r in block)
                    if members not in created:
                        if len(members) == world_size:
                            created[members] = dist.group.WORLD
                        elif len(members) == 1:
                            created[members] = None
                        else:
                            created[members] = dist.new_group(list(members))
                    if rank in members:
                        self._groups[frozenset(axes)] = created[members]

    def size(self, *axes: str) -> int:
        return int(np.prod([self.shape[a] for a in axes]))

    def index(self, *axes: str) -> int:
        """This rank's row-major index over ``axes`` (its group rank)."""
        i = 0
        for a in axes:
            i = i * self.shape[a] + self.coords[a]
        return i

    def group(self, *axes: str):
        """The process group over ``axes`` (``None`` when it is this rank alone)."""
        return self._groups[frozenset(axes)]

    @property
    def data_rank(self) -> int:
        """Which slice of the global batch this rank reads (tp and sp peers
        read the same rows)."""
        return self.index("dp", "fsdp")

    @property
    def data_world(self) -> int:
        return self.size("dp", "fsdp")

    def element_shard(self, time=None) -> ElementShard:
        """Where this rank's activations sit in the global batch, for the
        dropout hashes (``time=(t0, t_full)`` inside the time-sharded stack)."""
        return ElementShard(self.data_rank, time)

    def local_rows(self, x):
        """This rank's rows (dim 0) of a global batch field: a tensor or
        array, split into ``data_world`` equal blocks in data-rank order."""
        n = x.shape[0]
        if n % self.data_world:
            raise ValueError(f"batch of {n} rows does not split over {self.data_world} "
                             "data ranks")
        step = n // self.data_world
        return x[self.data_rank * step:(self.data_rank + 1) * step]

    def local_batch(self, batch: dict) -> dict:
        """:meth:`local_rows` of every array field of a batch dict."""
        return {k: self.local_rows(v) if getattr(v, "ndim", 0) else v
                for k, v in batch.items()}

    # ------------------------------------------------------------------
    # Placement, use and reduction of sharded trees
    # ------------------------------------------------------------------

    def _chunk(self, x: torch.Tensor, dim: int, entry) -> torch.Tensor:
        axes = _axes_of(entry)
        n = self.size(*axes)
        return x.chunk(n, dim)[self.index(*axes)] if n > 1 else x

    def local_shard(self, x: torch.Tensor, spec: Spec) -> torch.Tensor:
        """This rank's shard of a full tensor."""
        for dim, entry in enumerate(spec.dims):
            x = self._chunk(x, dim, entry)
        return x

    def _gather(self, x, spec: Spec, keep_tp: bool, grad: bool):
        for dim, entry in enumerate(spec.dims):
            axes = _axes_of(entry)
            if "fsdp" in axes:
                x = (comm.gather_sum_grad if grad else comm.gather_from_group)(
                    x, self.group("fsdp"), dim)
            if "tp" in axes and not keep_tp:
                x = comm.gather_from_group(x, self.group("tp"), dim)
        return x

    def use_params(self, params, specs, tp_bodies: Sequence[str] = (), grad: bool = True):
        """The tree the forward uses: each sharded leaf all-gathered, except
        that under a path prefix of ``tp_bodies`` a tp-sharded leaf stays
        its shard and a 1-D leaf of a column-parallel module is cut to this
        rank's chunk (gradient all-gathered). ``grad=False`` gathers without
        building gradients (evaluation, generation, checkpoints)."""
        tp_group = self.group("tp")

        def use(path, x, spec):
            if x is None:
                return None
            in_body = tp_group is not None and any(path.startswith(b) for b in tp_bodies)
            x = self._gather(x, spec, in_body, grad)
            if in_body and x.ndim == 1 and any(k in f"/{path}/" for k in COLUMN_PARALLEL):
                x = comm.scatter_to_group(x, tp_group, 0)
            return x

        return tree_map(use, tree_paths(params), params, specs)

    def full_params(self, params, specs):
        """Every leaf gathered whole (no gradient)."""
        return self.use_params(params, specs, grad=False)

    def reduce_grads(self, grads, specs, sp_paths: Sequence[str] = ()):
        """Sum each leaf's gradient over dp, over fsdp where the leaf is not
        fsdp-sharded (a sharded one was reduce-scattered by its gather), and
        over sp under a prefix of ``sp_paths``: one flat all-reduce per set
        of axes."""
        paths = tree_leaves(tree_paths(grads))
        leaves = tree_leaves(grads)
        spec_leaves = tree_leaves(specs)
        buckets: Dict[tuple, list] = {}
        for i, (path, g) in enumerate(zip(paths, leaves)):
            if g is None:
                continue
            axes = ("dp",) + (() if "fsdp" in spec_leaves[i].axes() else ("fsdp",))
            if any(path.startswith(p) for p in sp_paths):
                axes += ("sp",)
            buckets.setdefault(axes, []).append(i)
        out = list(leaves)
        for axes, idx in buckets.items():
            group = self.group(*axes)
            if group is None:
                continue
            flat = torch.cat([leaves[i].reshape(-1) for i in idx])
            summed = comm.all_reduce(flat, group, in_place=True)
            for i, part in zip(idx, summed.split([leaves[i].numel() for i in idx])):
                out[i] = part.view_as(leaves[i])
        it = iter(out)
        return tree_map(lambda _: next(it), grads)

    def global_norm(self, tree, specs) -> torch.Tensor:
        """sqrt of the sum of squares of the whole (unsharded) tree: each
        sharded leaf's shards summed over its axes, each replicated leaf
        counted once (``None`` leaves are zero)."""
        leaves = tree_leaves(tree)
        sums: Dict[tuple, torch.Tensor] = {}
        for x, spec in zip(leaves, tree_leaves(specs)):
            if x is None:
                continue
            axes = tuple(a for a in AXES if a in spec.axes())
            sq = (x.float() * x.float()).sum()
            sums[axes] = sums[axes] + sq if axes in sums else sq
        total = None
        for axes, s in sorted(sums.items()):
            s = comm.all_reduce(s, self.group(*axes)) if axes else s
            total = s if total is None else total + s
        if total is None:
            return torch.zeros((), dtype=torch.float32)
        return torch.sqrt(total)


def make_mesh(dp: int = 1, fsdp: int = 1, tp: int = 1, sp: int = 1, pp: int = 1) -> Mesh:
    """The mesh of the initialized process group. Its size must be the
    world size; ``pp > 1`` is not ported yet."""
    if pp > 1:
        raise NotImplementedError(f"mesh_pp={pp}: pipeline parallelism is not ported yet "
                                  f"({PIPELINE_ITEM})")
    sizes = {"dp": dp, "fsdp": fsdp, "tp": tp, "sp": sp, "pp": pp}
    if any(v < 1 for v in sizes.values()):
        raise ValueError(f"mesh axes must be >= 1, got {sizes}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.distributed.initialize)")
    world_size = dist.get_world_size()
    n = dp * fsdp * tp * sp * pp
    if n != world_size:
        raise ValueError(f"mesh {sizes} has {n} ranks, the process group {world_size}")
    return Mesh(sizes, dist.get_rank(), world_size)


def place_params(params, specs, mesh: Mesh):
    """This rank's shards of a full parameter tree, as fresh contiguous
    tensors on each leaf's device."""
    return tree_map(lambda x, spec: mesh.local_shard(x, spec).clone(
        memory_format=torch.contiguous_format), params, specs)
