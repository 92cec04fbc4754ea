from .checkpoint import CheckpointManager
from .optim import ChainOptimizer, build_lr_schedule, build_optimizer
from .runner import EpochBasedRunner, IterBasedRunner, LogBuffer, effective_interval
from .train_state import TrainState, make_eval_step, make_train_step, trainable_parameters

__all__ = ['ChainOptimizer', 'build_lr_schedule', 'build_optimizer', 'TrainState', 'make_train_step',
           'make_eval_step', 'trainable_parameters', 'CheckpointManager', 'EpochBasedRunner', 'IterBasedRunner',
           'effective_interval', 'LogBuffer']
