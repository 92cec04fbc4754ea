from .formatting import Formatting, format_img, format_reg, format_seg
from .label_maps import BoundLabelMake, DirectionLabelMake, DistanceLabelMake, HVLabelMake, UNetLabelMake
from .transforms import (Affine, CenterCrop, ColorJitter, Identity, Normalize, Pad, RandomBlur, RandomCrop, RandomFlip,
                         Rng)


def _not_ported(name: str, where: str, item: str):
    """A pipeline op of the JAX package that the port does not have yet: it
    raises when a config builds it."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f'{name} is not ported (tiseg_tpu/datasets/ops/{where}; ROADMAP queue A item {item})')

    return type(name, (), {'__init__': __init__, '__doc__': f'Not ported: tiseg_tpu/datasets/ops/{where}.'})


Resize = _not_ported('Resize', 'transforms.py', '4')
RandomRotate = _not_ported('RandomRotate', 'transforms.py', '4')
RandomSparseRotate = _not_ported('RandomSparseRotate', 'transforms.py', '4')
RandomElasticDeform = _not_ported('RandomElasticDeform', 'transforms.py', '4')
AlbuColorJitter = _not_ported('AlbuColorJitter', 'transforms.py', '4')

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
