from .instance_pp import instance_postprocess_plain, instance_postprocess_sweep
from .sliding import (resize_bilinear, reverse_tta_transform, split_inference, tta_forward_views,
                      tta_transform, tta_views)

__all__ = ['instance_postprocess_plain', 'instance_postprocess_sweep', 'resize_bilinear',
           'reverse_tta_transform', 'split_inference', 'tta_forward_views', 'tta_transform', 'tta_views']
