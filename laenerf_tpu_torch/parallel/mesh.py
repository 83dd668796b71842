"""Ray data-parallelism over torch.distributed (counterpart of
laenerf_tpu/parallel/mesh.py).

Rays (the batch axis) are split into equal shards, one per rank;
parameters, the optimizer state and the occupancy grid are replicated.
dp_train_step is DDP's step made explicit: each rank renders and
backprops its shard (K1 runs inside the hash-grid backward), then one
all-reduce averages the flattened gradients and the loss, and every rank
applies the same Adam and EMA update. The process group is NCCL for CUDA
devices and gloo for the CPU.
"""

import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group."""

    rank: int
    world_size: int
    device: torch.device


def make_mesh(device="cuda", *, rank=None, world_size=None,
              init_method=None):
    """Join (or reuse) the default process group and return this rank's
    Mesh. rank, world_size and init_method are explicit, or all three come
    from torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT; LOCAL_RANK picks the GPU). NCCL on a CUDA device, gloo on
    the CPU."""
    device = torch.device(device)
    if rank is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing and not dist.is_initialized():
            raise RuntimeError(
                f"make_mesh: no rank given and no torchrun environment "
                f"({', '.join(missing)} unset); launch with torchrun or "
                f"pass rank, world_size and init_method")
        rank = int(os.environ.get("RANK", 0))
        world_size = int(os.environ.get("WORLD_SIZE", 1))
        init_method = init_method or "env://"
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", device.index if device.index
                              is not None else local)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method=init_method, rank=rank, world_size=world_size)
    if (dist.get_rank(), dist.get_world_size()) != (rank, world_size):
        raise RuntimeError("make_mesh: the process group exists with another "
                           "rank or world size")
    return Mesh(rank=rank, world_size=world_size, device=device)


def destroy_mesh():
    """Leave the default process group (if this process joined one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def shard_batch(mesh: Mesh, x):
    """This rank's equal slice of x along its leading (ray) axis."""
    n = x.shape[0]
    if n % mesh.world_size:
        raise ValueError(f"shard_batch: {n} rows do not split into "
                         f"{mesh.world_size} equal shards")
    k = n // mesh.world_size
    return x[mesh.rank * k:(mesh.rank + 1) * k]


@torch.no_grad()
def replicate(mesh: Mesh, *modules_or_tensors):
    """Broadcast parameters, buffers and tensors from rank 0, in place, so
    every rank starts from the same state."""
    for obj in modules_or_tensors:
        tensors = (list(obj.parameters()) + list(obj.buffers())
                   if isinstance(obj, torch.nn.Module) else [obj])
        for t in tensors:
            dist.broadcast(t.data, src=0)


def _all_gather(mesh: Mesh, x):
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def dp_train_step(mesh: Mesh, net, ema_net, optimizer, scheduler, occupancy,
                  pose, intrinsics, inds, pixels, *, render_cfg, ema_decay,
                  has_alpha, bg_white, H, W, bg=None, noises=None,
                  generator=None):
    """One train step with the batch's rays sharded over the ranks.

    inds [N], pixels [N, 3|4] and bg [N, 3] (optional) are the whole
    batch, the same on every rank; this rank takes its shard of each.
    noises: optional [N / world_size] march perturbation of this rank's
    shard (decorrelated across ranks, as the JAX package's fold_in of the
    rank); otherwise drawn from `generator`, which the caller seeds per
    rank. Returns aux as train_step's: the loss averaged over ranks and
    per_ray_error, n_samples of the whole batch in rank order.
    """
    from ..train.trainer import _ema_update, train_loss

    inds, pixels = shard_batch(mesh, inds), shard_batch(mesh, pixels)
    if bg is not None:
        bg = shard_batch(mesh, bg)
    optimizer.zero_grad(set_to_none=True)
    loss, per_ray, out = train_loss(
        net, occupancy, pose, intrinsics, inds, pixels,
        render_cfg=render_cfg, has_alpha=has_alpha, bg_white=bg_white, H=H,
        W=W, bg=bg, noises=noises, generator=generator)
    loss.backward()
    # one all-reduce of every gradient and the loss, flattened together
    params = [p for p in net.parameters() if p.requires_grad]
    flat = torch.cat([p.grad.reshape(-1) for p in params]
                     + [loss.detach().reshape(1)])
    dist.all_reduce(flat)
    flat /= mesh.world_size
    offset = 0
    for p in params:
        p.grad.copy_(flat[offset:offset + p.numel()].view_as(p))
        offset += p.numel()
    optimizer.step()
    scheduler.step()
    _ema_update(net, ema_net, ema_decay)
    return {"loss": flat[-1].clone(),
            "per_ray_error": _all_gather(mesh, per_ray.detach()),
            "n_samples": _all_gather(mesh, out["n_samples"])}
