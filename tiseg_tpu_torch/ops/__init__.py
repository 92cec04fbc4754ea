from .flood import ccl_filter_sweep, ccl_sweep, fill_holes_sweep, size_filter
from .hover import hover_post_proc_device
from .instance_pp import instance_postprocess_plain, instance_postprocess_sweep
from .mt_instance_pp import mt_instance_postprocess_plain, mt_instance_postprocess_sweep
from .sliding import (resize_bilinear, reverse_tta_transform, split_inference, tta_forward_views,
                      tta_transform, tta_views)
from .watershed import watershed

__all__ = ['ccl_filter_sweep', 'ccl_sweep', 'fill_holes_sweep', 'hover_post_proc_device',
           'instance_postprocess_plain', 'instance_postprocess_sweep', 'mt_instance_postprocess_plain',
           'mt_instance_postprocess_sweep', 'resize_bilinear', 'reverse_tta_transform',
           'size_filter', 'split_inference', 'tta_forward_views', 'tta_transform', 'tta_views', 'watershed']
