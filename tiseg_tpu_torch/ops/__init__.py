from .ccl import instance_postprocess_device
from .flood import ccl_filter_sweep, ccl_sweep, fill_holes_sweep, size_filter
from .fused_decode import fused_decode0_cls
from .hover import hover_post_proc_device
from .instance_pp import instance_postprocess_plain, instance_postprocess_sweep
from .mt_instance_pp import mt_instance_postprocess_plain, mt_instance_postprocess_sweep
from .rounds import ccl_rounds, fill_holes_rounds, instance_postprocess_rounds
from .sliding import (resize_bilinear, reverse_tta_transform, split_inference, tta_forward_views,
                      tta_transform, tta_views)
from .stencil import neighborhood_max_3x3, neighborhood_min_3x3
from .watershed import watershed

__all__ = ['ccl_filter_sweep', 'ccl_rounds', 'ccl_sweep', 'fill_holes_rounds', 'fill_holes_sweep',
           'fused_decode0_cls', 'hover_post_proc_device', 'instance_postprocess_device',
           'instance_postprocess_plain', 'instance_postprocess_rounds', 'instance_postprocess_sweep',
           'mt_instance_postprocess_plain', 'mt_instance_postprocess_sweep', 'neighborhood_max_3x3',
           'neighborhood_min_3x3', 'resize_bilinear', 'reverse_tta_transform', 'size_filter', 'split_inference',
           'tta_forward_views', 'tta_transform', 'tta_views', 'watershed']
