from .builder import DATASETS, DataLoader, EpochSampler, build_dataloader, build_dataset, collate, sample_seed
from .custom import CPM17Dataset, CoNSePDataset, CustomDataset, GlasDataset, MoNuSegDataset, OSCDDataset
from .conic import CoNICDataset
from .mapper import DatasetMapper, read_image
from . import ops, utils  # noqa: F401

__all__ = [
    'DATASETS', 'DataLoader', 'EpochSampler', 'build_dataloader', 'build_dataset', 'collate', 'sample_seed',
    'CustomDataset', 'MoNuSegDataset', 'CPM17Dataset', 'CoNSePDataset', 'GlasDataset', 'OSCDDataset', 'CoNICDataset',
    'DatasetMapper', 'read_image'
]
