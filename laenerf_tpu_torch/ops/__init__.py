from .activation import trunc_exp
from .sh import sh_encode, sh_output_dim
from .freq import freq_encode, freq_output_dim
from .morton import morton3d, morton3d_invert, packbits, unpackbits
from .scatter_add import scatter_add_rows, scatter_add_rows_plain
from .gather import (take_rows, take_rows_plain, take_lanes, take_lanes_plain,
                     grid_probe, grid_probe_plain)
from .sorted_scatter import (tile_scatter, tile_scatter_plain,
                             worklist_scatter, worklist_scatter_plain)
from .hashgrid import (HashGridSpec, hashgrid_encode, hashgrid_init,
                       hashgrid_tv_loss)
from .raymarch import (MarchConfig, near_far_from_aabb, march_rays_train,
                       sph_from_ray)
from .composite import composite_rays_train, composite_chunk
from .compaction import packed_sample_indices, scatter_back
