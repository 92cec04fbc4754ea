from .builder import BACKBONES, HEADS, LOSSES, SEGMENTORS, build_backbone, build_head, build_loss, build_segmentor
from .segmentors import (CDNet, CDNetNet, HoverNet, HoverNetNet, MTCDNetNet, MTUNetNet, MultiTaskCDNet,
                         MultiTaskCDNetDebug, MultiTaskCUNet, MultiTaskCUNetDebug, MultiTaskUNet, UNet, UNetNet)

__all__ = ['BACKBONES', 'HEADS', 'LOSSES', 'SEGMENTORS', 'build_backbone', 'build_head', 'build_loss',
           'build_segmentor', 'CDNet', 'CDNetNet', 'HoverNet', 'HoverNetNet', 'MTCDNetNet', 'MTUNetNet', 'MultiTaskCDNet', 'MultiTaskCDNetDebug', 'MultiTaskCUNet',
           'MultiTaskCUNetDebug', 'MultiTaskUNet', 'UNet', 'UNetNet']
