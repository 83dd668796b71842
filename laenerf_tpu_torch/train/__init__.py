from .trainer import (Trainer, train_step, train_step_clip, occ_update,
                      make_optimizer)
from .checkpoints import CheckpointManager, load_pytree, save_pytree
from .metrics import LPIPSMeter, psnr, psnr_meter, ssim, ssim_meter
from .losses import mape_loss, huber_loss, eff_distloss
