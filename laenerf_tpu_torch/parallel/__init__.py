from .mesh import (Mesh, make_mesh, shard_batch, replicate, dp_train_step,
                   destroy_mesh)
from .render import dp_render_image
