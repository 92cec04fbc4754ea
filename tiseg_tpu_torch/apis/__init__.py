from .test import InferenceRunner, single_device_test
from .train import build_train_state, init_random_seed

__all__ = ['InferenceRunner', 'build_train_state', 'init_random_seed', 'single_device_test']
