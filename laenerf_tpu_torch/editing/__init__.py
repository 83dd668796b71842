from .editgrid import EditGrid, EDIT_GRIDSIZE, voxelize_points, cell_world_pos
from .laenerf import (LAENeRF, LAENeRFConfig, LAENeRFLosses, laenerf_init,
                      laenerf_forward_train, laenerf_weights, prune_palette)
from .edit_dataset import EditDataset
from .style_trainer import (LAENeRFTrainer, StyleLossWeights,
                            laenerf_train_step, make_style_optimizer)
from .distill import distill_dataset
from .vgg import (VGG16_LAYOUT, VGG19_LAYOUT, lpips_fn, normalize_imagenet,
                  vgg_features, vgg_init)
from .style import StyleNetwork, gram_matrices, match_color
from .semantic import COLOR_LAYERS, FEAT_LAYERS, SemanticEncoder, nnfm_loss
from .npr_dataset import SingleViewEditDataset
from .npr_trainer import NPRTrainer, build_npr_nerf_dataset, npr_train_step
