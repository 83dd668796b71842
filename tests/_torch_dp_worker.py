"""Worker processes of tests/test_torch_parallel.py: each joins a gloo
group through a file:// rendezvous (no port to collide on) and runs one
rank of the port's data-parallel step or render. Imports torch and the
port only, so a spawned process starts without JAX."""

import numpy as np
import torch

from laenerf_tpu_torch.models import nerf_init
from laenerf_tpu_torch.parallel import (destroy_mesh, dp_render_image,
                                        dp_train_step, make_mesh, replicate)
from laenerf_tpu_torch.train.trainer import make_optimizer


def _setup(rank, world_size, init_file, job):
    torch.set_num_threads(1)
    mesh = make_mesh("cpu", rank=rank, world_size=world_size,
                     init_method=f"file://{init_file}")
    net = nerf_init(job["model_cfg"], device="cpu")
    net.load_state_dict(job["state_dict"])
    return mesh, net


def train(rank, world_size, init_file, job_path, out_prefix):
    """One dp_train_step from job["state_dict"] with this rank's noises;
    saves the loss, the averaged gradients and the new parameters."""
    job = torch.load(job_path, weights_only=False)
    mesh, net = _setup(rank, world_size, init_file, job)
    try:
        ema = nerf_init(job["model_cfg"], device="cpu")
        ema.load_state_dict(job["state_dict"])
        ema.requires_grad_(False)
        opt, sched = make_optimizer(net.parameters(), 1e-2, 100)
        aux = dp_train_step(
            mesh, net, ema, opt, sched, job["occ"], job["pose"],
            job["intr"], job["inds"], job["pixels"],
            render_cfg=job["render_cfg"], ema_decay=0.95, has_alpha=True,
            bg_white=False, H=job["H"], W=job["W"], bg=job["bg"],
            noises=job["noises"][rank])
        out = {"loss": aux["loss"].numpy(),
               "per_ray_error": aux["per_ray_error"].numpy()}
        for name, p in net.named_parameters():
            out["grad." + name] = p.grad.numpy()
            out["param." + name] = p.detach().numpy()
        np.savez(f"{out_prefix}{rank}.npz", **out)
    finally:
        destroy_mesh()


def render(rank, world_size, init_file, job_path, out_prefix):
    """dp_render_image of job's camera; saves the frame each rank gets.
    Ranks past 0 start from a zeroed table and an empty grid, which
    replicate overwrites with rank 0's."""
    job = torch.load(job_path, weights_only=False)
    mesh, net = _setup(rank, world_size, init_file, job)
    occ = job["occ"].clone()
    try:
        if rank:
            net.encoder.data.zero_()
            occ.zero_()
        replicate(mesh, net, occ)
        img, depth = dp_render_image(
            mesh, net, occ, job["pose"], job["intr"], job["H"],
            job["W"], render_cfg=job["render_cfg"], chunk=job["chunk"])
        np.savez(f"{out_prefix}{rank}.npz", image=img, depth=depth)
    finally:
        destroy_mesh()
