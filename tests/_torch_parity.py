"""Shared fixtures of the JAX-vs-port parity tests (tests/test_torch_*.py):
small configurations, seeded parameters and occupancy grids, made with
numpy and handed to both packages."""

import dataclasses

import jax
import numpy as np
import torch

from laenerf_tpu.models import NeRFConfig as JNeRFConfig
from laenerf_tpu.models import RenderConfig as JRenderConfig
from laenerf_tpu.models import nerf_init as jnerf_init
from laenerf_tpu_torch.convert import params_from_jax
from laenerf_tpu_torch.models import NeRFConfig, RenderConfig, nerf_init

# the model of tests/test_model_render.py (every grid level hashed)
J_MODEL_CFG = JNeRFConfig(bound=1.0, num_levels=4, log2_hashmap_size=12)
J_RENDER_CFG = JRenderConfig(bound=1.0, cascades=1, grid_size=32,
                             max_steps=128, march_iters=128, m_cap_per_ray=96,
                             infer_chunk_events=8)


def port_cfg(jcfg, cls):
    """The port's config with the same field values."""
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(cls)})


MODEL_CFG = port_cfg(J_MODEL_CFG, NeRFConfig)
RENDER_CFG = port_cfg(J_RENDER_CFG, RenderConfig)


def jax_params(seed=0, table_scale=0.5):
    """JAX-initialised params with the table and weights spread wide enough
    that density and color vary across the scene; numpy leaves."""
    params = jnerf_init(jax.random.PRNGKey(seed), J_MODEL_CFG)
    rng = np.random.RandomState(seed)
    tree = {
        "encoder": rng.uniform(-table_scale, table_scale,
                               params["encoder"].shape).astype(np.float32),
        "sigma_net": [4.0 * np.asarray(w) for w in params["sigma_net"]],
        "color_net": [2.0 * np.asarray(w) for w in params["color_net"]],
    }
    return tree


def port_net(tree, cfg=MODEL_CFG):
    net = nerf_init(cfg, device="cpu")
    net.load_state_dict(params_from_jax(tree))
    return net


def blob_occupancy(seed=0, H=32, cas=1):
    rng = np.random.RandomState(seed)
    occ = (rng.rand(cas, H, H, H) > 0.8).astype(np.uint8)
    occ[:, H // 4:3 * H // 4, H // 4:3 * H // 4, H // 3:2 * H // 3] = 1
    return occ


def camera_rays(seed, n, spread=0.5):
    rng = np.random.RandomState(seed)
    eye = np.array([0.2, -0.3, -2.5], np.float32)
    tgt = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = tgt - eye
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.broadcast_to(eye, d.shape).copy(), d


def t(a, dtype=None):
    return torch.tensor(np.asarray(a), dtype=dtype)
