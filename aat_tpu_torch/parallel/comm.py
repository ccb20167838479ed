"""Collectives over a process group, and their gradients.

The Megatron pair for tensor parallelism: :func:`copy_to_group`
(identity forward, all-reduce backward: a replicated input feeding
column-parallel products) and :func:`reduce_from_group` (all-reduce
forward, identity backward: the partial products of a row-parallel one,
whose consumers are replicated). For sharded leaves and activations:
:func:`gather_sum_grad` (all-gather forward, reduce-scatter backward: the
fsdp gather, whose users see different rows), :func:`gather_from_group`
(all-gather forward, own chunk backward: the users are replicated) and
:func:`scatter_to_group` (own chunk forward, all-gather backward).
:func:`all_reduce_sum` sums with a summed gradient (batch-norm statistics
over the data ranks), :func:`all_to_all` is Ulysses' exchange, and
:func:`ring_permute` the pipeline's hand-off (JAX's ``lax.ppermute`` over
``pp``: send to the next rank of the group, receive from the previous one;
its gradient goes round the reverse ring). A ``group`` of ``None`` is a
group of one rank: every function is then the identity.

The backend runs each collective on the tensor as it is, except where gloo
has none for it: gloo's ``reduce_scatter`` is built from its
``all_reduce`` and the rank's own chunk, and a CUDA tensor's
``all_to_all`` and point-to-point exchange go through host memory (gloo's
run on CPU tensors only). :data:`calls` counts each collective by its
route, and :data:`ring_bytes` the bytes the ring permute sent.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

calls: collections.Counter = collections.Counter()  # {"op (route)": count}
ring_bytes: collections.Counter = collections.Counter()  # {"forward" | "backward": bytes sent}


def _route(op: str, x: torch.Tensor, group) -> str:
    backend = dist.get_backend(group)
    if backend != "gloo" or op in ("all_reduce", "all_gather"):
        return backend
    if op == "reduce_scatter":
        return "gloo all_reduce + own chunk"
    return "gloo through host memory" if x.is_cuda else "gloo"


def _count(op: str, x: torch.Tensor, group) -> str:
    route = _route(op, x, group)
    calls[f"{op} ({route})"] += 1
    return route


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM,
               in_place: bool = False) -> torch.Tensor:
    """The reduction of ``x`` over ``group`` (no gradient): a new tensor, or
    ``x`` itself with ``in_place`` (a buffer the caller owns)."""
    out = x.detach() if in_place else x.detach().clone()
    if group is not None:
        _count("all_reduce", out, group)
        dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    _count("all_gather", x, group)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def _own_chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    return x.chunk(n, dim)[dist.get_rank(group)].contiguous()


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    if _count("reduce_scatter", x, group) != "nccl":
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return _own_chunk(out, group, dim)
    chunks = [c.contiguous() for c in x.chunk(dist.get_world_size(group), dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


def _all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    send = torch.stack(x.chunk(n, split_dim)).contiguous()  # [n, ...]: chunk j to rank j
    route = _count("all_to_all", send, group)
    staged = route == "gloo through host memory"
    if staged:
        send = send.cpu()
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group)
    if staged:
        out = out.to(x.device)
    return torch.cat(out.unbind(0), concat_dim)  # chunk i came from rank i


def _ring(x: torch.Tensor, group, shift: int, direction: str) -> torch.Tensor:
    """Send ``x`` to the group rank ``shift`` ahead (mod the group's size)
    and return what the rank ``shift`` behind sent. Every send and receive
    of the step is posted before any is waited on: a blocking send then
    receive would deadlock the ring."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    send = x.contiguous()
    route = _count("ring_permute", send, group)
    ring_bytes[direction] += send.numel() * send.element_size()
    staged = route == "gloo through host memory"
    if staged:
        send = send.cpu()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, (me + shift) % n), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (me - shift) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device) if staged else recv


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ring(x, group, 1, "forward")

    @staticmethod
    def backward(ctx, g):
        return _ring(g, ctx.group, -1, "backward"), None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own_chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own_chunk(g, ctx.group, ctx.dim), None, None


class _GatherSumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.dims = group, (split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(g, ctx.group, concat_dim, split_dim), None, None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllReduceSum.apply(x, group)


def scatter_to_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group is None else _Scatter.apply(x, group, dim)


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group is None else _Gather.apply(x, group, dim)


def gather_sum_grad(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return x if group is None else _GatherSumGrad.apply(x, group, dim)


def ring_permute(x: torch.Tensor, group) -> torch.Tensor:
    """What the previous rank of ``group`` passed (each rank passes ``x`` to
    the next, the last to the first); the gradient goes back round the
    reverse ring."""
    return x if group is None else _RingPermute.apply(x, group)


def all_to_all(x: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Chunk ``split_dim`` over the group's ranks (chunk j to rank j) and
    concatenate what arrives along ``concat_dim`` (rank i's chunk i-th)."""
    return x if group is None else _AllToAll.apply(x, group, split_dim, concat_dim)
