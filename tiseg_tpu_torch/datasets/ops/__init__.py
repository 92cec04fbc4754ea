from .formatting import Formatting, format_img, format_reg, format_seg
from .label_maps import BoundLabelMake, DirectionLabelMake, DistanceLabelMake, HVLabelMake, UNetLabelMake
from .transforms import (Affine, AlbuColorJitter, CenterCrop, ColorJitter, Identity, Normalize, Pad, RandomBlur,
                         RandomCrop, RandomElasticDeform, RandomFlip, RandomRotate, RandomSparseRotate, Resize, Rng)

__all__ = [
    'BoundLabelMake', 'DirectionLabelMake', 'DistanceLabelMake', 'HVLabelMake', 'UNetLabelMake', 'Affine',
    'AlbuColorJitter', 'CenterCrop', 'ColorJitter', 'Identity', 'Normalize', 'Pad', 'RandomBlur', 'RandomCrop',
    'RandomElasticDeform', 'RandomFlip', 'RandomRotate', 'RandomSparseRotate', 'Resize', 'Formatting', 'format_img',
    'format_reg', 'format_seg', 'class_dict', 'Rng'
]

# name -> class resolution for pipeline configs (reference
# tiseg/datasets/ops/__init__.py:18-40 uses a plain dict, not the registry)
class_dict = {
    'AlbuColorJitter': AlbuColorJitter,
    'ColorJitter': ColorJitter,
    'CenterCrop': CenterCrop,
    'RandomFlip': RandomFlip,
    'Resize': Resize,
    'RandomElasticDeform': RandomElasticDeform,
    'RandomCrop': RandomCrop,
    'RandomRotate': RandomRotate,
    'RandomSparseRotate': RandomSparseRotate,
    'RandomBlur': RandomBlur,
    'Normalize': Normalize,
    'Pad': Pad,
    'Affine': Affine,
    'Identity': Identity,
    'BoundLabelMake': BoundLabelMake,
    'DirectionLabelMake': DirectionLabelMake,
    'DistanceLabelMake': DistanceLabelMake,
    'UNetLabelMake': UNetLabelMake,
    'HVLabelMake': HVLabelMake,
    'Formatting': Formatting,
}
