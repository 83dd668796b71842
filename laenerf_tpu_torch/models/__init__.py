from .mlp import MLP, mlp_init, mlp_apply
from .nerf import (NeRFConfig, NeRFNetwork, nerf_init, nerf_forward,
                   nerf_density, nerf_color, nerf_background)
from .occupancy import (OccupancyState, occupancy_init, update_occupancy,
                        mark_untrained_grid)
from .renderer import (RenderConfig, render_rays_train, render_rays_infer,
                       render_rays_distill)
from .stratified import render_rays_stratified, sample_pdf
