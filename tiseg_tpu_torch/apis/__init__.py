from .test import InferenceRunner
from .train import build_train_state, init_random_seed

__all__ = ['InferenceRunner', 'build_train_state', 'init_random_seed']
