"""Camera-batch data parallelism, as tpugs/parallel/sharded_train.py:
params replicated on every rank, the view batch split over the mesh's
"data" axis, the gradients averaged over the data group, and the same
Adam step on every rank (so the replicas stay bit-identical).

tpugs lets XLA write the gradient psum from sharding annotations inside
one process; here each rank renders its block of views, and one
all_reduce over the data group averages the flattened gradients."""
from __future__ import annotations

import dataclasses

import torch

from tpugs_torch.ops.render import RasterConfig, render
from tpugs_torch.optim.adam import AdamConfig, adam_step
from tpugs_torch.parallel import comm
from tpugs_torch.parallel.mesh import Mesh
from tpugs_torch.train.loss import combined_loss


def make_dp_train_step(mesh: Mesh, raster: RasterConfig,
                       adam_cfg: AdamConfig = AdamConfig(),
                       lambda_ssim: float = 0.2, sh_degree: int = 0):
    """step_fn(params, alive, adam_state, images [b,H,W,3], viewmats
    [b,4,4], intrinsics [b,4], step) -> (params, adam_state, loss), where b
    is this rank's block of the batch (shard_batch): the loss and the
    gradient are the means over the whole batch of B = b x D views."""

    def step_fn(params, alive, adam_state, images, viewmats, intrinsics,
                step):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        bg = torch.zeros(3, device=images.device)
        losses = []
        for image, viewmat, intr in zip(images, viewmats, intrinsics):
            out = render(p["means"], p["quats"], p["log_scales"],
                         p["opacity_logits"], p["sh"], alive, viewmat, intr,
                         raster, sh_degree, bg)
            losses.append(combined_loss(out.color, image, lambda_ssim))
        loss = torch.mean(torch.stack(losses))
        names = list(p)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        with torch.no_grad():
            grads = comm.mean_over_data(dict(zip(names, grads)), mesh)
            loss = comm.all_reduce(loss.detach(), mesh, "data", "mean")
            new_params, new_adam = adam_step(adam_cfg, adam_state, params,
                                             grads, step)
        return new_params, new_adam, loss

    return step_fn


def _to(x, device):
    return torch.as_tensor(x).to(device)


def shard_batch(mesh: Mesh, *arrays):
    """This rank's block of each array's leading axis (split evenly over
    the data axis), on its device."""
    out = []
    for a in arrays:
        b = a.shape[0]
        if b % mesh.data:
            raise ValueError(f"batch of {b} does not split over "
                             f"data={mesh.data}")
        k = b // mesh.data
        out.append(_to(a[mesh.data_index * k:(mesh.data_index + 1) * k],
                       mesh.device))
    return tuple(out)


def replicate(mesh: Mesh, tree):
    """Every tensor (or array) of a dict, list or tuple tree on this rank's
    device, whole."""
    if isinstance(tree, dict):
        return {k: replicate(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f: replicate(mesh, getattr(tree, f))
            for f in tree.__dataclass_fields__})
    return _to(tree, mesh.device)
