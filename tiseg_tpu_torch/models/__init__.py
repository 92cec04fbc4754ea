from .builder import BACKBONES, HEADS, SEGMENTORS, build_segmentor
from .segmentors import (CDNet, CDNetNet, HoverNet, HoverNetNet, MTCDNetNet, MTUNetNet, MultiTaskCDNet,
                         MultiTaskCDNetDebug, MultiTaskCUNet, MultiTaskCUNetDebug, MultiTaskUNet, UNet, UNetNet)

__all__ = ['BACKBONES', 'HEADS', 'SEGMENTORS', 'build_segmentor', 'CDNet', 'CDNetNet', 'HoverNet', 'HoverNetNet',
           'MTCDNetNet', 'MTUNetNet', 'MultiTaskCDNet', 'MultiTaskCDNetDebug', 'MultiTaskCUNet',
           'MultiTaskCUNetDebug', 'MultiTaskUNet', 'UNet', 'UNetNet']
