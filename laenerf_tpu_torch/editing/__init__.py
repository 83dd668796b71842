from .editgrid import EditGrid, EDIT_GRIDSIZE, voxelize_points, cell_world_pos
from .laenerf import (LAENeRF, LAENeRFConfig, LAENeRFLosses, laenerf_init,
                      laenerf_forward_train, laenerf_weights, prune_palette)
from .edit_dataset import EditDataset
from .style_trainer import (LAENeRFTrainer, StyleLossWeights,
                            laenerf_train_step, make_style_optimizer)
from .distill import distill_dataset
