from .rays import get_rays, pixel_rays, tile_raster_order
from .provider import NeRFDataset, nerf_matrix_to_ngp
from .synthetic import generate_synthetic_scene
