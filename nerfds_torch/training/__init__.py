"""L4 training layer, counterpart of ``nerfds_tpu/training``."""
from nerfds_torch.training import losses, schedules
from nerfds_torch.training.step import (AdamState, TrainState,
                                        build_schedules, eval_schedules,
                                        make_fused_train_step, make_loss_fn,
                                        make_train_step)

__all__ = ['losses', 'schedules', 'AdamState', 'TrainState',
           'build_schedules', 'eval_schedules', 'make_fused_train_step',
           'make_loss_fn', 'make_train_step']
