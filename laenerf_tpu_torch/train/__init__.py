from .trainer import Trainer, train_step, occ_update, make_optimizer
