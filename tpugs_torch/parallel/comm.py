"""The mesh's collectives, each over one axis's process group.

Three are differentiable, as torch.autograd.Functions, because tpugs'
shard_map differentiates through its collectives:

- all_to_all (the tile exchange): its backward is the reverse all_to_all,
  which returns each received record's gradient to the rank that sent it;
- all_gather (the colour tiles, gauss_shard's attributes): its backward
  returns this rank's slice of the cotangent;
- all_reduce_sum (the shard sums of MCMC's regularization): its backward
  passes the cotangent through.

The last two backwards are what holds when every rank of the group
differentiates the same replicated loss, which is how the mesh steps use
them: the loss of a data row is computed identically on each of its G
ranks, and each rank differentiates its own copy. So the port's raw
gradient on a rank is d(its data row's loss)/d(its shard), factor 1, and
the mean over the data group is the normalised gradient. tpugs' raw
shard_map gradient is d(sum of all D*G devices' losses)/d(shard), which
carries G x (sum over data rows), and tpugs divides by G after its mean
over "data" (dist_train.py:240, gauss_shard.py:92-95); both land on the
mean over views of each view's gradient. torch.distributed.nn's
all_gather is not used: its backward is a reduce-scatter, which would
carry the factor G.

On an axis of size 1 every collective is the identity. The rest are plain
(no gradient): all_reduce with a sum, mean or max.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from tpugs_torch.parallel.mesh import BOTH, Mesh


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = torch.empty_like(grad)
        dist.all_to_all_single(out, grad.contiguous(), group=ctx.group)
        return out, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size: int, index: int):
        ctx.index, ctx.n = index, x.shape[0]
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.n
        return grad[lo:lo + ctx.n], None, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str = "gauss"):
    """x [size, ...]: block j goes to the axis's rank j; block j of the
    result came from rank j."""
    if mesh.axis_size(axis) == 1:
        return x
    return _AllToAll.apply(x, mesh.group(axis))


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str = "gauss"):
    """The axis's ranks' x concatenated on dim 0, in rank order."""
    size = mesh.axis_size(axis)
    if size == 1:
        return x
    return _AllGather.apply(x, mesh.group(axis), size, mesh.axis_index(axis))


def all_reduce_sum(x: torch.Tensor, mesh: Mesh, axis: str = "gauss"):
    """The sum of x over the axis (differentiable, see the docstring)."""
    if mesh.axis_size(axis) == 1:
        return x
    return _AllReduceSum.apply(x, mesh.group(axis))


def all_reduce(x: torch.Tensor, mesh: Mesh, axis, op: str = "sum"):
    """x reduced over the axis ("sum", "mean" or "max"), no gradient. A
    bool is reduced as int32."""
    size = mesh.axis_size(axis)
    if size == 1:
        return x
    is_bool = x.dtype == torch.bool
    out = x.detach().to(torch.int32) if is_bool else x.detach().clone()
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    dist.all_reduce(out, op=red, group=mesh.group(axis))
    if op == "mean":
        out = out / size
    return out > 0 if is_bool else out


def mean_over_data(grads: dict, mesh: Mesh) -> dict:
    """Each gradient averaged over the data group, in one collective."""
    if mesh.data == 1:
        return grads
    names = list(grads)
    flat = torch.cat([grads[k].reshape(-1) for k in names])
    flat = all_reduce(flat, mesh, "data", "mean")
    out, at = {}, 0
    for k in names:
        n = grads[k].numel()
        out[k] = flat[at:at + n].reshape(grads[k].shape)
        at += n
    return out


def barrier(mesh: Mesh):
    """Wait for every rank of the mesh (a one-element sum over both axes)."""
    all_reduce(torch.zeros(1, device=mesh.device), mesh, BOTH)
