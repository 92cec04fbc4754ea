from .test import InferenceRunner, gather_object_shards, multi_process_test, single_device_test
from .train import build_train_state, init_random_seed, train_segmentor

__all__ = ['InferenceRunner', 'build_train_state', 'gather_object_shards', 'init_random_seed', 'multi_process_test',
           'single_device_test', 'train_segmentor']
