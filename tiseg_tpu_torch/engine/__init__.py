from .optim import ChainOptimizer, build_lr_schedule, build_optimizer
from .train_state import TrainState, make_eval_step, make_train_step, trainable_parameters

__all__ = ['ChainOptimizer', 'build_lr_schedule', 'build_optimizer', 'TrainState', 'make_train_step',
           'make_eval_step', 'trainable_parameters']
